"""``calibrate.py`` with the faults and controls of every traffic mode
(``modes/extensions.py``), the same arguments:

    python3 port_bench/calibrate_all.py --workload jamba2_3b_train_s8k_bf16 \
        --seeds 11,12,13 [--control | --fault scan_bf16] [--out r.jsonl]
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from port_bench import calibrate  # noqa: E402
from port_bench.modes import extensions  # noqa: E402

if __name__ == "__main__":
    extensions.register()
    sys.exit(calibrate.main(sys.argv[1:]))

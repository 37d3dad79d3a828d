"""The port's dataset scripts (``utils/setup_pad.py``, ``setup_fetal.py``,
``split_data.py``) against the JAX package's, on the CPU.

Each script runs on its own copy of one synthetic tree of placeholder files
(no image is decoded, so no PIL is needed); the trees they leave must hold
the same files, byte for byte, and the functions return the same values.
The command lines are the same too.
"""
import csv
import os
import subprocess
import sys

import pytest

from medmamba_tpu.utils import setup_fetal as jax_fetal
from medmamba_tpu.utils import setup_pad as jax_pad
from medmamba_tpu.utils import split_data as jax_split
from medmamba_tpu_torch.utils import setup_fetal, setup_pad, split_data

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tree(root) -> dict:
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for base, _, names in os.walk(root):
        for n in names:
            path = os.path.join(base, n)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def _files(root, names, sub=""):
    os.makedirs(os.path.join(root, sub), exist_ok=True)
    for n in names:
        with open(os.path.join(root, sub, n), "wb") as f:
            f.write(n.encode())


def _pad_tree(root):
    _files(root, ["PAT_1_2_3.png", "PAT_1_2_4.PNG", "PAT_9_1_1.png",
                  "PAT_7_7_7.png", "not_matching.png", "PAT_1_2.png"],
           "images")
    with open(os.path.join(root, "metadata.csv"), "w", newline="") as f:
        w = csv.DictWriter(f, ["patient_id", "lesion_id", "diagnostic"])
        w.writeheader()
        w.writerow({"patient_id": "PAT_1", "lesion_id": "2",
                    "diagnostic": "NEV"})
        w.writerow({"patient_id": "PAT_9", "lesion_id": "1",
                    "diagnostic": "BCC"})


def _fetal_tree(root):
    _files(root, ["Patient01_Plane1_1of2.png", "Patient02_Plane3_1of1.png",
                  "patient02_plane3_2of2.png", "Other_Plane2_1.png",
                  "Patient03_Plane5_x.txt"], "Images")


def _split_tree(root):
    for cls, n in (("a", 20), ("b", 7), ("c", 1)):
        _files(root, [f"{i}.png" for i in range(n)], cls)
    with open(os.path.join(root, "stray.txt"), "w") as f:
        f.write("not a class")


@pytest.mark.parametrize("script", ["pad", "fetal"])
def test_setup_scripts_match_jax(tmp_path, script, capsys):
    make, port_fn, jax_fn = {
        "pad": (_pad_tree, setup_pad.setup_pad, jax_pad.setup_pad),
        "fetal": (_fetal_tree, setup_fetal.setup_fetal,
                  jax_fetal.setup_fetal)}[script]
    trees = {}
    for side, fn in (("port", port_fn), ("jax", jax_fn)):
        root = str(tmp_path / side)
        make(root)
        out = fn(root)
        assert os.path.relpath(out, root) == "classified"
        trees[side] = _tree(root)
    assert trees["port"] == trees["jax"]
    assert any(k.startswith("classified") for k in trees["port"])
    logs = capsys.readouterr().out.splitlines()
    assert logs[0].replace(str(tmp_path / "port"), "R") == \
        logs[1].replace(str(tmp_path / "jax"), "R")


@pytest.mark.parametrize("move", [False, True])
@pytest.mark.parametrize("ratio,seed", [((0.6, 0.1, 0.3), 42),
                                        ((0.5, 0.25, 0.25), 7)])
def test_split_data_matches_jax(tmp_path, ratio, seed, move):
    trees, counts = {}, {}
    for side, fn in (("port", split_data.split_data),
                     ("jax", jax_split.split_data)):
        root = tmp_path / side
        _split_tree(str(root / "in"))
        counts[side] = fn(str(root / "in"), str(root / "out"), ratio=ratio,
                          seed=seed, move=move)
        trees[side] = _tree(root)
    assert counts["port"] == counts["jax"]
    assert trees["port"] == trees["jax"]


def test_split_data_refuses_ratios_that_do_not_sum_to_one(tmp_path):
    with pytest.raises(ValueError, match="sum to 1"):
        split_data.split_data(str(tmp_path), str(tmp_path / "o"),
                              ratio=(0.5, 0.1, 0.1))


def test_command_lines_match_jax(tmp_path):
    """``python -m medmamba_tpu_torch.utils.<script>`` with the JAX
    module's flags leaves the JAX module's tree."""
    runs = [("setup_pad", _pad_tree, ["--images_subdir", "images"]),
            ("setup_fetal", _fetal_tree, []),
            ("split_data", _split_tree, None)]
    for name, make, extra in runs:
        trees = {}
        for side, pkg in (("port", "medmamba_tpu_torch"),
                          ("jax", "medmamba_tpu")):
            root = tmp_path / name / side
            if extra is None:
                make(str(root / "in"))
                argv = ["--input", str(root / "in"), "--output",
                        str(root / "out"), "--ratio", "0.5", "0.3", "0.2",
                        "--seed", "3", "--move"]
            else:
                make(str(root))
                argv = ["--root", str(root)] + extra
            subprocess.run([sys.executable, "-m", f"{pkg}.utils.{name}",
                            *argv], cwd=REPO, check=True,
                           capture_output=True, timeout=120)
            trees[side] = _tree(root)
        assert trees["port"] == trees["jax"], name

"""How far medmamba_t's Grad-CAMs through the scan kernels lie from the
plain scan's, on the card.

A CAM is discontinuous where an activation in front of a ReLU crosses zero,
so a rounding-level difference of the forward can move it by far more than
rounding. For random medmamba_t weights from 3 seeds and 8 standard
normal 224^2 inputs each, this computes each CAM through the kernels
(K1 forward, K2 backward) and through the plain-scan model at the kernels'
activations, substituted either at the targets alone or at the targets and
every block's output (``grad_cam(..., substitute=...)``), and prints the
largest difference per target and how many images exceed 1e-4. Run from the
root of a checkout on a machine with a card:

    python -m medmamba_tpu_torch.tools.cam_agreement
"""
from __future__ import annotations

import torch

from medmamba_tpu_torch.eval.gradcam import (block_paths, grad_cam,
                                             target_activations)
from medmamba_tpu_torch.models.registry import create_model

TARGETS = (["layers_3.blocks_1.conv1x1"],
           ["layers_2.blocks_0.conv1x1", "layers_3.blocks_1.conv1x1"],
           ["layers_0.blocks_1.conv_bn0"])
LIMIT = 1e-4
SEEDS, BATCH = 3, 8


def main() -> None:
    for seed in range(SEEDS):
        model = create_model("T", 9, generator=torch.Generator()
                             .manual_seed(seed)).eval()
        ref = create_model("T", 9, scan_impl="ref")
        ref.load_state_dict(model.state_dict())
        ref.eval()
        x = torch.randn(BATCH, 224, 224, 3, device="cuda",
                        generator=torch.Generator(device="cuda")
                        .manual_seed(100 + seed))
        with torch.no_grad():
            pred = model(x).argmax(-1)
        for paths in TARGETS:
            got = grad_cam(model, x, target_class=pred, target_paths=paths)
            line = [f"seed {seed} {' + '.join(paths)}:"]
            for tag, sites in (("at the targets", paths),
                               ("and every block", paths + block_paths(model))):
                acts = target_activations(model, x, sites)
                want = grad_cam(ref, x, target_class=pred, target_paths=paths,
                                substitute=dict(zip(sites, acts)))
                err = abs(got - want).reshape(BATCH, -1).max(1)
                line.append(f"{tag} max {err.max():.2e} ({(err > LIMIT).sum()}"
                            f" of {BATCH} above {LIMIT})")
            print(line[0], "; ".join(line[1:]), flush=True)


if __name__ == "__main__":
    main()

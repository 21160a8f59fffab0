"""Strip the solver state from one of the port's checkpoints (counterpart
of the root ``tools/remove_solver_states.py``): keeps ``"model"`` and
``"iteration"``, drops ``"optimizer"`` and ``"scheduler"``, for a
weights-only file to hand on.

    python -m oneshotdet_tpu_torch.tools.remove_solver_states --in X.pth --out Y.pth
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--in", dest="inp", required=True)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)

    import torch

    data = torch.load(args.inp, map_location="cpu", weights_only=True)
    slim = {k: data[k] for k in ("model", "iteration") if k in data}
    out = os.path.abspath(args.out)
    torch.save(slim, out)
    print(f"wrote weights-only checkpoint to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

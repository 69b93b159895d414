"""Loss-curve plotting from the training JSON log (port of
``tpupose/apps/plot_log.py``, the reference's ``plot_train_log.py``): the
``log`` of ``tpupose_torch.utils.reporting.TrainLogger`` (LogReport's
format) -> ``loss_history.png``.  matplotlib is imported when it runs.

Usage: python -m tpupose_torch.apps.plot_log result/run1 [--out x.png]
"""

from __future__ import annotations

import argparse
import json
import os


def main(argv=None):
    p = argparse.ArgumentParser(description="Plot training loss history")
    p.add_argument("log_dir", help="directory containing the 'log' file")
    p.add_argument("--out", default=None,
                   help="output image (default <log_dir>/loss_history.png)")
    args = p.parse_args(argv)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    with open(os.path.join(args.log_dir, "log")) as f:
        entries = json.load(f)
    iters = [e["iteration"] for e in entries]

    fig, ax = plt.subplots(figsize=(8, 5))
    for key, style in (("main/loss", "-"), ("val/loss", "--")):
        ys = [(e["iteration"], e[key]) for e in entries if key in e]
        if ys:
            ax.plot([p_[0] for p_ in ys], [p_[1] for p_ in ys], style,
                    label=key)
    ax.set_xlabel("iteration")
    ax.set_ylabel("loss")
    ax.set_yscale("log")
    ax.legend()
    ax.grid(True, alpha=0.3)
    out = args.out or os.path.join(args.log_dir, "loss_history.png")
    fig.savefig(out, dpi=120, bbox_inches="tight")
    print("wrote", out, f"({len(iters)} log entries)")


if __name__ == "__main__":
    main()

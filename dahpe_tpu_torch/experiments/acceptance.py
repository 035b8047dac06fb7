"""Published-checkpoint accuracy acceptance, in one command.

Port of ``dahpe_tpu/experiments/acceptance.py``. Evaluating the reference's
released checkpoints (``H3D_best_754.pth`` / ``STB_best_750.pth``) through
the port must land PCK@0.05 within ±0.5 points of the published number.
The released checkpoints and datasets are not in the repository, so this is
the staged form of the check: once they are there,

    python -m dahpe_tpu_torch.experiments.acceptance <target_root> \\
        --source_root <rhd_root> -t Hand3DStudio \\
        --checkpoint models/H3D_best_754.pth

runs the port's eval CLI (``cli.test``: the strict ``.pth`` import, on the
card unless ``--device cpu``) and judges the result. The expected score is
parsed from the checkpoint file name's trailing number (``_754`` → 75.4)
unless ``--expected`` is given; ``--tolerance`` defaults to 0.5.

Exit code 0 = within tolerance; 1 = outside; 2 = could not run (missing
checkpoint, data or expected score), so a blocked check is not a failed one.
"""

from __future__ import annotations

import json
import os
import re
import sys
import tempfile


def parse_expected(checkpoint: str) -> float | None:
    """``H3D_best_754.pth`` → 75.4 (the reference names checkpoints by their
    PCK@0.05 percentage × 10)."""
    m = re.search(r"_(\d{3})\.pth$", os.path.basename(checkpoint))
    return int(m.group(1)) / 10.0 if m else None


def run_acceptance(argv=None) -> int:
    from dahpe_tpu_torch.cli.args import build_parser

    parser = build_parser("test")
    parser.add_argument("--expected", type=float, default=None,
                        help="published PCK@0.05 in percent (default: parsed from the "
                             "checkpoint file name)")
    parser.add_argument("--tolerance", type=float, default=0.5,
                        help="acceptance band in PCK points")
    args = parser.parse_args(argv)

    if not args.checkpoint:
        print("acceptance: --checkpoint <published .pth> is required")
        return 2
    expected = args.expected
    if expected is None:
        expected = parse_expected(args.checkpoint)
        if expected is None:
            print("acceptance: cannot parse the expected score from "
                  f"{args.checkpoint!r}; pass --expected")
            return 2
    if not os.path.exists(args.checkpoint):
        print(f"acceptance: BLOCKED — checkpoint {args.checkpoint} absent")
        return 2
    if not os.path.isdir(args.target_root):
        print(f"acceptance: BLOCKED — dataset root {args.target_root} absent "
              "(see docs/DATA.md for the expected layout)")
        return 2
    if not os.path.isdir(args.source_root):
        # cli.test scores the source val split beside the target
        print(f"acceptance: BLOCKED — source root {args.source_root} absent "
              "(see docs/DATA.md)")
        return 2

    if args.log == build_parser("test").get_default("log"):
        args.log = tempfile.mkdtemp(prefix="acceptance_")

    from dahpe_tpu_torch.cli import test as test_cli

    test_cli.main(args)
    records = [json.loads(line) for line in open(os.path.join(args.log, "metrics.jsonl"))]
    evals = [r for r in records if r.get("kind") == "eval"]
    assert evals, "cli.test wrote no eval record"
    target = evals[-1]["val_target"]
    got = 100.0 * target["all"]
    delta = got - expected
    ok = abs(delta) <= args.tolerance
    print(json.dumps({
        "checkpoint": args.checkpoint,
        "target": args.target,
        "pck_at_005_percent": round(got, 2),
        "published": expected,
        "delta": round(delta, 2),
        "tolerance": args.tolerance,
        "per_group": {k: round(100.0 * v, 2) for k, v in target.items()},
        "accepted": ok,
    }))
    print(f"acceptance: {'PASS' if ok else 'FAIL'} "
          f"({got:.2f} vs published {expected:.2f} ±{args.tolerance})")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(run_acceptance())

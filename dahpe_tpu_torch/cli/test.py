"""Evaluation CLI: ``python -m dahpe_tpu_torch.cli.test``.

Port of ``dahpe_tpu/cli/test.py`` (the reference's ``test.py:37-227``):
``python -m dahpe_tpu_torch.cli.test <target_root> -t STB --checkpoint <path>``
loads a checkpoint (a packed directory of this package or of the JAX
package, or a reference torch ``.pth`` such as the published
``STB_best_750.pth``) and reports per-group PCK@0.05 on the source and
target test splits, from host loaders or, with ``--device-store``,
device-resident ones. ``--artifact model.pt2`` evaluates an exported serving
artifact instead (``cli.export``, float or int8, float32 input): the same
loaders and PCK grouping, scoring the artifact's own decoded coordinates, so
a float artifact reproduces its checkpoint's PCK exactly. ``--bf16`` builds
the checkpoint's model computing in bfloat16 (an artifact records its own
dtype); ``--debug`` draws the target split's printed host batches.
"""

from __future__ import annotations

import sys

from dahpe_tpu_torch.cli.args import build_parser
from dahpe_tpu_torch.cli.common import (
    build_datasets,
    build_device_val_loader,
    build_model,
    build_val_loader,
    make_visualizer,
    refuse_unported,
)
from dahpe_tpu_torch.evaluate import make_artifact_eval_step, make_eval_step, validate
from dahpe_tpu_torch.utils import checkpoint as ckpt
from dahpe_tpu_torch.utils.logging import RunLogger


def main(args) -> dict:
    """Evaluate ``args.checkpoint`` or ``args.artifact``; returns
    ``{"source": pck, "target": per-group pck}``."""
    # argument contract first: failing after the dataset build and upload
    # would waste minutes on a usage error
    refuse_unported(args)
    if (args.checkpoint is None) == (args.artifact is None):
        raise SystemExit("pass exactly one of --checkpoint / --artifact")
    logger = RunLogger(args.log, "test")
    try:
        print(args)
        # evaluation needs only the two val splits
        (_, val_source, _, val_target) = build_datasets(args, val_only=True)
        if args.device_store:
            val_source_loader = build_device_val_loader(args, val_source, name="source")
            val_target_loader = build_device_val_loader(args, val_target, name="target")
        else:
            val_source_loader = build_val_loader(args, val_source)
            val_target_loader = build_val_loader(args, val_target)

        if args.artifact:
            # deployment acceptance: drive the exported program (float or
            # int8) and score its own decoded coordinates
            from dahpe_tpu_torch import serving
            from dahpe_tpu_torch.quant import to_torch

            model = None
            predict = serving.load_predict_file(args.artifact, device=args.device)
            weights = to_torch(serving.load_artifact_weights(args.artifact + ".weights.npz"),
                               args.device)
            print(f"loaded artifact {args.artifact}")
            eval_step = make_artifact_eval_step(predict, weights, image_size=args.image_size,
                                                heatmap_size=args.heatmap_size)
        else:
            model = build_model(args, multi_head=True)
            if args.checkpoint.endswith(".pth"):
                ckpt.load_reference_pth(args.checkpoint, model, strict=True)
            else:
                model.load_state_dict(ckpt.load_model_variables(args.checkpoint))
            print(f"loaded {args.checkpoint}")
            eval_step = make_eval_step(model, device=args.device)
        kw = dict(image_size=args.image_size, heatmap_size=args.heatmap_size,
                  print_freq=args.print_freq, eval_step=eval_step, device=args.device)
        src_acc = validate(val_source_loader, model, val_source, **kw)
        tgt_acc = validate(val_target_loader, model, val_target,
                           visualize=make_visualizer(val_target, logger) if args.debug
                           else None, **kw)
        print(f"Source: {src_acc['all']:4.3f} Target: {tgt_acc['all']:4.3f}")
        for name, acc in tgt_acc.items():
            print(f"{name}: {acc:4.3f}")
        logger.log_metrics(kind="eval", checkpoint=args.checkpoint or args.artifact,
                           val_source=src_acc["all"], val_target=tgt_acc)
        return {"source": src_acc["all"], "target": tgt_acc}
    finally:
        logger.close()


if __name__ == "__main__":
    main(build_parser("test").parse_args(sys.argv[1:]))

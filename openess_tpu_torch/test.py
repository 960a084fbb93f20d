"""Evaluation entry point of the port (the counterpart of ``test.py``):
restores a checkpoint and runs confusion-matrix mIoU / accuracy over the
validation split.

    python -m openess_tpu_torch.test --settings_file configs/<cfg>.yaml \\
        [--checkpoint <file or dir>] [--device cuda|cpu]
"""
import argparse
import logging

from openess_tpu_torch import resolve_device
from openess_tpu_torch.config.settings import load_settings
from openess_tpu_torch.data.loaders import build_datasets
from openess_tpu_torch.training.trainer import Trainer


def main(argv=None):
    parser = argparse.ArgumentParser(description="Evaluate openess_tpu_torch.")
    parser.add_argument("--settings_file", required=True)
    parser.add_argument("--checkpoint", default="",
                        help="checkpoint file, or a directory of ckpt_*.pt")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a GPU) or cpu")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    settings = load_settings(args.settings_file, generate_log=False)
    if args.checkpoint:
        settings.resume_training = True
        settings.resume_ckpt_file = args.checkpoint

    device = resolve_device(args.device)
    _, val_ds = build_datasets(settings, device)
    trainer = Trainer(settings, val_ds, val_ds, device=device)
    summary = trainer.val_epochs()
    print({k: round(float(v), 2) for k, v in summary.items() if k != "cm"})


if __name__ == "__main__":
    main()

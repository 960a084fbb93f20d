"""Train entry point of the port (the counterpart of ``train.py``).

    python -m openess_tpu_torch.train --settings_file configs/<cfg>.yaml \\
        [--no_log_dir] [--device cuda|cpu] [--profile DIR]

Dispatches to the workload encoded in the YAML's ``clip`` section
(``if_supervised_only`` / ``if_pretraining`` / ...). Runs on the CUDA card
unless ``--device cpu`` is given. A synthetic dataset
(``dataset.name_b: synthetic_events``) needs nothing on disk; DSEC and DDD17
are read from ``dataset_path``, on the raw-event wire or, with
``tpu.wire_format: grid`` and ``tpu.host_voxelize: false``, voxelized on the
device by the loader (K5, K6). Reading DSEC needs ``h5py``. ``--profile
DIR`` traces the whole run with ``torch.profiler`` into DIR
(``utils/profiling.trace``; the step's ``train/<part>`` spans are in it).
"""
import argparse
import contextlib
import logging

import numpy as np

from openess_tpu_torch import resolve_device
from openess_tpu_torch.config.settings import load_settings
from openess_tpu_torch.data.loaders import build_datasets
from openess_tpu_torch.training.build import task_from_settings
from openess_tpu_torch.training.trainer import Trainer
from openess_tpu_torch.utils.profiling import trace


def main(argv=None):
    parser = argparse.ArgumentParser(description="Train openess_tpu_torch.")
    parser.add_argument("--settings_file", required=True,
                        help="Path to settings yaml")
    parser.add_argument("--no_log_dir", action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a GPU) or cpu")
    parser.add_argument(
        "--profile", metavar="DIR", default="",
        help="trace the run with torch.profiler into DIR (a "
             "TensorBoard-loadable Chrome trace)")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    settings = load_settings(args.settings_file,
                             generate_log=not args.no_log_dir)
    np.random.seed(settings.seed)

    device = resolve_device(args.device)
    train_ds, val_ds = build_datasets(settings, device)
    trainer = Trainer(settings, train_ds, val_ds, device=device)
    ctx = trace(args.profile) if args.profile else contextlib.nullcontext()
    with ctx:
        if task_from_settings(settings) == "pretrain":
            trainer.pretraining()
        else:
            best = trainer.training()
            if best:
                print({k: v for k, v in best.items()
                       if k in ("miou", "acc")})


if __name__ == "__main__":
    main()

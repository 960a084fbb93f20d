"""Synthetic ESS dataset: correlated events/frames/labels for tests and
smoke runs. Own copy of ``openess_tpu/data/synthetic.py`` (numpy only): the
same seed gives the same samples and, through the port's C++ packer, the
same wire batches.

A tiny, self-consistent dataset exercising the full train path without
DSEC/DDD17 on disk. Scenes are piecewise-constant label maps; frames/recons
are label-correlated grayscale-ish images; events fire at label boundaries
(where a moving edge would generate them), so a working model can actually
fit it.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class SyntheticESS:
    num_samples: int = 16
    height: int = 64
    width: int = 96
    num_classes: int = 6
    num_windows: int = 4
    events_per_window: int = 2000
    superpixel_size: int = 20
    seed: int = 1205

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        self._cache = [self._make(i) for i in range(self.num_samples)]

    def _make(self, idx):
        rng = np.random.default_rng(self.seed * 1000 + idx)
        h, w, c = self.height, self.width, self.num_classes
        # piecewise-constant label map from random low-res seeds
        seeds = rng.integers(0, c, (4, 6))
        ys = np.linspace(0, 4, h, endpoint=False).astype(int)
        xs = np.linspace(0, 6, w, endpoint=False).astype(int)
        label = seeds[np.ix_(ys, xs)].astype(np.int64)

        # frame: per-class base intensity + noise, RGB in [0,1]
        base = rng.uniform(0.1, 0.9, (c, 3))
        frame = base[label] + rng.normal(0, 0.03, (h, w, 3))
        frame = np.clip(frame, 0, 1).astype(np.float32)
        recon = np.clip(
            frame.mean(-1, keepdims=True) + rng.normal(0, 0.02, (h, w, 1)), 0, 1
        )
        recon = np.repeat(recon, 3, axis=-1).astype(np.float32)

        # pseudo-labels: mostly correct with some corruption
        pl = label.copy()
        corrupt = rng.random((h, w)) < 0.15
        pl[corrupt] = rng.integers(0, c, corrupt.sum())

        # superpixels: grid blocks (ids < superpixel_size)
        sp_rows = max(1, int(np.sqrt(self.superpixel_size * h / w)))
        sp_cols = max(1, self.superpixel_size // sp_rows)
        ry = np.minimum((np.arange(h) * sp_rows) // h, sp_rows - 1)
        rx = np.minimum((np.arange(w) * sp_cols) // w, sp_cols - 1)
        superpixel = (ry[:, None] * sp_cols + rx[None, :]).astype(np.int64)

        # events at label boundaries (half) + class-textured interiors
        # (half): each class has its own interior event rate and polarity
        # bias, the way real scene textures differ — without interior
        # events a segmentation model could never label region interiors
        # from the event stream alone
        edges = np.zeros((h, w), bool)
        edges[:, 1:] |= label[:, 1:] != label[:, :-1]
        edges[1:, :] |= label[1:, :] != label[:-1, :]
        ey, ex = np.nonzero(edges)
        n = self.num_windows * self.events_per_window
        ne = n // 2
        pick = rng.integers(0, len(ey), ne)
        x_e = ex[pick].astype(np.float32)
        y_e = ey[pick].astype(np.float32)
        p_e = rng.integers(0, 2, ne).astype(np.float32)

        class_rate = np.linspace(0.2, 1.0, c)  # interior density per class
        weights = class_rate[label].reshape(-1)
        weights = weights / weights.sum()
        ni = n - ne
        flat = rng.choice(h * w, size=ni, p=weights)
        y_i = (flat // w).astype(np.float32)
        x_i = (flat % w).astype(np.float32)
        pol_bias = np.linspace(0.15, 0.85, c)  # P(positive) per class
        p_i = (rng.random(ni) < pol_bias[label.reshape(-1)[flat]]).astype(
            np.float32
        )

        x = np.concatenate([x_e, x_i])
        y = np.concatenate([y_e, y_i])
        p = np.concatenate([p_e, p_i])
        order = rng.permutation(n)
        jitter = rng.uniform(-0.5, 0.5, (2, n)).astype(np.float32)
        x = x[order] + jitter[0]
        y = y[order] + jitter[1]
        p = p[order]
        t = np.sort(rng.uniform(0, 1e6, n)).astype(np.float32)

        sam_feat = rng.normal(0, 1, (16, 16, 256)).astype(np.float32)
        return {
            "events_xypt": (x, y, p, t),
            "frame": frame,
            "recon": recon,
            "label": label.astype(np.int32),
            "pl": pl.astype(np.int32),
            "superpixel": superpixel.astype(np.int32),
            "sam_feat": sam_feat,
        }

    def __len__(self):
        return self.num_samples

    def __getitem__(self, idx):
        return self._cache[idx]

    def raw_wire_batch(self, indices, num_bins: int = 5,
                       t16: bool = True) -> dict:
        """Batch with events on the compact sorted-chunk wire, packed by the
        C++ packer and trimmed to the bucketed batch-max chunk count; the
        train step voxelizes it on the device (K1). ``t16`` is the v2 time
        wire (uint16 relative time, 7 B/event), the ``wire_t16``
        default."""
        from openess_tpu_torch.data.device_voxelize import pack_wire_batch
        from openess_tpu_torch.native import chunk_events_windows_host

        out = {k: [] for k in ("frame", "recon", "label", "pl",
                               "superpixel", "sam_feat")}
        xs, ys, ps, ts, vs = [], [], [], [], []
        T = self.num_windows
        for i in indices:
            s = self._cache[i]
            x, y, p, t = s["events_xypt"]
            xs.append(x.reshape(T, -1))
            ys.append(y.reshape(T, -1))
            ps.append(p.reshape(T, -1))
            ts.append(t.reshape(T, -1))
            vs.append(np.ones((T, x.size // T), bool))
            for k in out:
                out[k].append(s[k])
        batch = {k: np.stack(v) for k, v in out.items()}
        cat = lambda a: np.concatenate(a, axis=0)
        wire = chunk_events_windows_host(
            cat(xs), cat(ys), cat(ps), cat(ts).astype(np.float64), cat(vs),
            height=self.height, width=self.width, t16=t16,
        )
        batch.update(pack_wire_batch(wire, len(indices), T))
        return batch

    def voxelized_batch(self, indices, num_bins: int = 5,
                        device="cpu") -> dict:
        """Batch on the grid wire: each sample's events voxelized into
        planar ``[T, bins, H, W]`` f32 windows on ``device`` by the exact
        scatter (``ops/voxelize.voxelize_windows_trilinear``), stacked into
        the ``event`` tensor; the side channels stay numpy."""
        from openess_tpu_torch.ops.voxelize import voxelize_windows_trilinear

        out = {k: [] for k in ("frame", "recon", "label", "pl",
                               "superpixel", "sam_feat")}
        grids = []
        for i in indices:
            s = self._cache[i]
            x, y, p, t = (torch.from_numpy(a).to(device)
                          for a in s["events_xypt"])
            grid = voxelize_windows_trilinear(
                x, y, p, t, torch.ones_like(x, dtype=torch.bool),
                num_windows=self.num_windows, num_bins=num_bins,
                height=self.height, width=self.width,
            )
            grids.append(grid.view(self.num_windows, num_bins, self.height,
                                   self.width))
            for k in out:
                out[k].append(s[k])
        batch = {k: np.stack(v) for k, v in out.items()}
        batch["event"] = torch.stack(grids)
        return batch

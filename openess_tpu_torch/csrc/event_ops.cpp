// Host-side event-stream code of openess_tpu_torch: the port's own copy of
// the JAX package's native event code, the same functions with the same C
// interface and the same arithmetic.
//
// - voxelize_trilinear(_mt, _windows): DSEC's signed trilinear voxel grid,
//   one stream or a batch of padded windows parallel across windows, with
//   the nonzero normalization and the bottom crop;
// - voxelize_bilinear_t(_windows): DDD17's grid, integer pixels, bilinear
//   in time, per polarity;
// - event_histogram: the 2-channel (neg, pos) count image;
// - time_indices_offsets: a time window's bounds in a sorted stream;
// - chunk_events_phase_a / _b: the two-phase sorted-chunk wire packer whose
//   wire K1 and K4 voxelize on the card (ops/voxelize_chunked.py);
// - normalize_nonzero_inplace.
//
// Called through ctypes from openess_tpu_torch/native.py. Built at first
// use by ops/_build.py (build_host) with the host C++ compiler:
//   c++ -O3 -march=native -ffast-math -fPIC -shared -std=c++17 -pthread
// The voxelizers' sums are compiled with -ffast-math, so two libraries
// agree bit for bit only when built from the same source with the same
// flags; the packer is integer work and exact f32 steps either way.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <cmath>
#include <algorithm>
#include <thread>
#include <vector>

namespace {

// Nonzero mean/std normalization of a scratch grid. mode: 0 = none,
// 1 = unbiased std (torch default, representations.py:45-53),
// 2 = biased std (np.std, data_util.py:38-48).
void normalize_nonzero_mode(float* g, int64_t n, int mode) {
  if (mode == 0) return;
  double sum = 0, sq = 0;
  int64_t cnt = 0;
  for (int64_t i = 0; i < n; ++i) {
    const float v = g[i];
    if (v != 0.f) { sum += v; sq += (double)v * v; ++cnt; }
  }
  if (cnt == 0) return;
  const double mean = sum / cnt;
  double var = sq / cnt - mean * mean;
  if (mode == 1) {
    if (cnt < 2) return;
    var *= (double)cnt / (double)(cnt - 1);
  }
  if (var <= 0) return;
  const float m = (float)mean, inv = (float)(1.0 / std::sqrt(var));
  for (int64_t i = 0; i < n; ++i) {
    if (g[i] != 0.f) g[i] = (g[i] - m) * inv;
  }
}

}  // namespace

extern "C" {

// DSEC-style signed trilinear voxel grid (±polarity, 8-corner interpolation).
// x, y: rectified float coords; p in {0,1}; t monotonic. grid: [C*H*W] f32,
// assumed zero-initialized by the caller.
void voxelize_trilinear(
    const float* x, const float* y, const float* p, const float* t,
    int64_t n, int C, int H, int W, float* grid) {
  if (n == 0) return;
  const float t0v = t[0];
  float dt = t[n - 1] - t0v;
  if (dt <= 0.f) dt = 1.f;
  const float tscale = (C - 1) / dt;
  const int64_t HW = (int64_t)H * W;
  for (int64_t i = 0; i < n; ++i) {
    const float xf = x[i], yf = y[i];
    const float tn = (t[i] - t0v) * tscale;
    // trunc toward zero, matching torch .int() (representations.py:27-29)
    const int x0 = (int)xf, y0 = (int)yf, t0 = (int)tn;
    const float value = 2.f * p[i] - 1.f;
    for (int dx = 0; dx < 2; ++dx) {
      const int xl = x0 + dx;
      if (xl < 0 || xl >= W) continue;
      const float wx = 1.f - std::fabs((float)xl - xf);
      for (int dy = 0; dy < 2; ++dy) {
        const int yl = y0 + dy;
        if (yl < 0 || yl >= H) continue;
        const float wy = 1.f - std::fabs((float)yl - yf);
        for (int dtt = 0; dtt < 2; ++dtt) {
          const int tl = t0 + dtt;
          if (tl < 0 || tl >= C) continue;
          const float wt = 1.f - std::fabs((float)tl - tn);
          grid[tl * HW + (int64_t)yl * W + xl] += value * wx * wy * wt;
        }
      }
    }
  }
}

// Multithreaded trilinear voxelizer: events are partitioned across threads,
// each accumulating into a private grid (no atomics needed on any ISA),
// followed by a parallel tree-free reduction. The per-window time
// normalization uses the GLOBAL first/last timestamps, so results are
// bit-identical in structure to the single-threaded kernel.
void voxelize_trilinear_mt(
    const float* x, const float* y, const float* p, const float* t,
    int64_t n, int C, int H, int W, float* grid, int n_threads) {
  if (n == 0) return;
  if (n_threads <= 0) n_threads = (int)std::thread::hardware_concurrency();
  if (n_threads <= 1 || n < 65536) {
    voxelize_trilinear(x, y, p, t, n, C, H, W, grid);
    return;
  }
  const int64_t cells = (int64_t)C * H * W;
  const float t0v = t[0];
  float dt = t[n - 1] - t0v;
  if (dt <= 0.f) dt = 1.f;
  const float tscale = (C - 1) / dt;
  std::vector<std::vector<float>> priv(n_threads - 1);
  std::vector<std::thread> threads;
  const int64_t per = (n + n_threads - 1) / n_threads;

  auto work = [&](int ti, float* g) {
    const int64_t lo = ti * per;
    const int64_t hi = std::min(lo + per, n);
    const int64_t HW = (int64_t)H * W;
    for (int64_t i = lo; i < hi; ++i) {
      const float xf = x[i], yf = y[i];
      const float tn = (t[i] - t0v) * tscale;
      const int x0 = (int)xf, y0 = (int)yf, tt0 = (int)tn;
      const float value = 2.f * p[i] - 1.f;
      for (int dx = 0; dx < 2; ++dx) {
        const int xl = x0 + dx;
        if (xl < 0 || xl >= W) continue;
        const float wx = 1.f - std::fabs((float)xl - xf);
        for (int dy = 0; dy < 2; ++dy) {
          const int yl = y0 + dy;
          if (yl < 0 || yl >= H) continue;
          const float wy = 1.f - std::fabs((float)yl - yf);
          for (int dtt = 0; dtt < 2; ++dtt) {
            const int tl = tt0 + dtt;
            if (tl < 0 || tl >= C) continue;
            const float wt = 1.f - std::fabs((float)tl - tn);
            g[tl * HW + (int64_t)yl * W + xl] += value * wx * wy * wt;
          }
        }
      }
    }
  };

  for (int ti = 1; ti < n_threads; ++ti) {
    priv[ti - 1].assign(cells, 0.f);
    threads.emplace_back(work, ti, priv[ti - 1].data());
  }
  work(0, grid);
  for (auto& th : threads) th.join();
  for (auto& g : priv) {
    for (int64_t i = 0; i < cells; ++i) grid[i] += g[i];
  }
}

// Batched windowed DSEC trilinear voxelization: n_win independent windows,
// window w holding counts[w] valid events at offset w*K in the flat x/y/p/t
// arrays. Windows are distributed dynamically across n_threads; each thread
// reuses one private CHW scratch grid. Per window: trilinear scatter,
// optional nonzero normalization (norm_mode as above), bottom-crop, and the
// requested output layout. This batches the whole input-pipeline hot loop
// (dsec.py get_batch) into ONE native call whose parallel axis is the B*T
// window grid.
//
// layout 0: out[w] = [(H-crop_bottom), W, C] (HWC, strided transpose).
// layout 1: out[w] = [C, (H-crop_bottom), W] (planar CHW, pure memcpy) —
//   the grid wire's planar layout, the one the models take.
void voxelize_trilinear_windows(
    const float* x, const float* y, const float* p, const float* t,
    const int64_t* counts, int64_t n_win, int64_t K,
    int C, int H, int W, int crop_bottom, int norm_mode,
    float* out, int n_threads, int layout) {
  const int Ho = H - crop_bottom;
  const int64_t cells = (int64_t)C * H * W;
  const int64_t out_cells = (int64_t)Ho * W * C;
  if (n_threads <= 0) n_threads = (int)std::thread::hardware_concurrency();
  n_threads = (int)std::min<int64_t>(std::max(n_threads, 1), n_win);

  std::atomic<int64_t> next(0);
  auto work = [&]() {
    std::vector<float> scratch(cells);
    const int64_t HW = (int64_t)H * W;
    for (;;) {
      const int64_t w = next.fetch_add(1);
      if (w >= n_win) return;
      float* o = out + w * out_cells;
      const int64_t n = counts[w];
      if (n == 0) {
        std::memset(o, 0, out_cells * sizeof(float));
        continue;
      }
      float* g = scratch.data();
      std::memset(g, 0, cells * sizeof(float));
      voxelize_trilinear(x + w * K, y + w * K, p + w * K, t + w * K,
                         n, C, H, W, g);
      normalize_nonzero_mode(g, cells, norm_mode);
      if (layout == 1) {
        for (int c = 0; c < C; ++c) {
          std::memcpy(o + (int64_t)c * Ho * W, g + (int64_t)c * HW,
                      (size_t)Ho * W * sizeof(float));
        }
      } else {
        for (int c = 0; c < C; ++c) {
          const float* gc = g + (int64_t)c * HW;
          for (int h = 0; h < Ho; ++h) {
            const float* row = gc + (int64_t)h * W;
            float* orow = o + ((int64_t)h * W) * C + c;
            for (int wv = 0; wv < W; ++wv) orow[(int64_t)wv * C] = row[wv];
          }
        }
      }
    }
  };
  std::vector<std::thread> threads;
  for (int ti = 1; ti < n_threads; ++ti) threads.emplace_back(work);
  work();
  for (auto& th : threads) th.join();
}

// Batched windowed DDD17 voxelization (bilinear in t, per-polarity), same
// window layout as voxelize_trilinear_windows. out[w] = [H, W, Cout] with
// Cout = 2*C (separate_pol: pos bins then neg bins) or C (pos - neg);
// layout 1 emits planar [Cout, H, W] instead (the grid wire, memcpy).
void voxelize_bilinear_t_windows(
    const float* x, const float* y, const float* p, const float* t,
    const int64_t* counts, int64_t n_win, int64_t K,
    int C, int H, int W, int separate_pol, int norm_mode,
    float* out, int n_threads, int layout) {
  const int Cout = separate_pol ? 2 * C : C;
  const int64_t HW = (int64_t)H * W;
  const int64_t cells = (int64_t)C * HW;
  const int64_t out_cells = (int64_t)HW * Cout;
  if (n_threads <= 0) n_threads = (int)std::thread::hardware_concurrency();
  n_threads = (int)std::min<int64_t>(std::max(n_threads, 1), n_win);

  std::atomic<int64_t> next(0);
  auto work = [&]() {
    std::vector<float> pos(cells), neg(cells), merged;
    if (!separate_pol) merged.resize(cells);
    for (;;) {
      const int64_t w = next.fetch_add(1);
      if (w >= n_win) return;
      float* o = out + w * out_cells;
      const int64_t n = counts[w];
      if (n == 0) {
        std::memset(o, 0, out_cells * sizeof(float));
        continue;
      }
      std::memset(pos.data(), 0, cells * sizeof(float));
      std::memset(neg.data(), 0, cells * sizeof(float));
      // integer-coordinate variant taking float inputs (loader arrays are
      // f32); time math in double as in voxelize_bilinear_t
      {
        const float* xs = x + w * K;
        const float* ys = y + w * K;
        const float* ps = p + w * K;
        const float* ts = t + w * K;
        const double t0v = (double)ts[0];
        double dt = (double)ts[n - 1] - t0v;
        if (dt == 0) dt = 1.0;
        const double tscale = (C - 1) / dt;
        for (int64_t i = 0; i < n; ++i) {
          const int64_t xi = (int64_t)xs[i], yi = (int64_t)ys[i];
          if (xi < 0 || xi >= W || yi < 0 || yi >= H) continue;
          const double tsn = ((double)ts[i] - t0v) * tscale;
          if (tsn < 0 || tsn >= C) continue;
          const int ti = (int)tsn;
          const float dts = (float)(tsn - ti);
          float* g = (ps[i] == 1.f) ? pos.data() : neg.data();
          const int64_t base = (int64_t)yi * W + xi;
          if (ti < C) g[ti * HW + base] += 1.f - dts;
          if (ti + 1 < C) g[(ti + 1) * HW + base] += dts;
        }
      }
      if (separate_pol) {
        // normalize over the concatenated (pos, neg) grid like the numpy
        // reference (data_util.py:38-48 applies to the stacked grid)
        if (norm_mode) {
          std::vector<float>* grids[2] = {&pos, &neg};
          double sum = 0, sq = 0;
          int64_t cnt = 0;
          for (auto* gv : grids)
            for (int64_t i = 0; i < cells; ++i) {
              const float v = (*gv)[i];
              if (v != 0.f) { sum += v; sq += (double)v * v; ++cnt; }
            }
          if (cnt > 0) {
            const double mean = sum / cnt;
            double var = sq / cnt - mean * mean;
            if (norm_mode == 1 && cnt >= 2)
              var *= (double)cnt / (double)(cnt - 1);
            if (var > 0) {
              const float m = (float)mean, inv = (float)(1.0 / std::sqrt(var));
              for (auto* gv : grids)
                for (int64_t i = 0; i < cells; ++i)
                  if ((*gv)[i] != 0.f) (*gv)[i] = ((*gv)[i] - m) * inv;
            }
          }
        }
        if (layout == 1) {
          std::memcpy(o, pos.data(), (size_t)cells * sizeof(float));
          std::memcpy(o + cells, neg.data(), (size_t)cells * sizeof(float));
        } else {
          for (int c = 0; c < C; ++c) {
            const float* gp = pos.data() + (int64_t)c * HW;
            const float* gn = neg.data() + (int64_t)c * HW;
            for (int64_t hw = 0; hw < HW; ++hw) {
              o[hw * Cout + c] = gp[hw];
              o[hw * Cout + C + c] = gn[hw];
            }
          }
        }
      } else {
        for (int64_t i = 0; i < cells; ++i) merged[i] = pos[i] - neg[i];
        normalize_nonzero_mode(merged.data(), cells, norm_mode);
        if (layout == 1) {
          std::memcpy(o, merged.data(), (size_t)cells * sizeof(float));
        } else {
          for (int c = 0; c < C; ++c) {
            const float* gm = merged.data() + (int64_t)c * HW;
            for (int64_t hw = 0; hw < HW; ++hw) o[hw * Cout + c] = gm[hw];
          }
        }
      }
    }
  };
  std::vector<std::thread> threads;
  for (int ti = 1; ti < n_threads; ++ti) threads.emplace_back(work);
  work();
  for (auto& th : threads) th.join();
}

// DDD17-style voxel grid: integer coords, bilinear binning along time only,
// separate polarity grids (pos then neg), each [C*H*W] zero-initialized.
void voxelize_bilinear_t(
    const int64_t* xs, const int64_t* ys, const float* p, const int64_t* t,
    int64_t n, int C, int H, int W, float* grid_pos, float* grid_neg) {
  if (n == 0) return;
  const double t0v = (double)t[0];
  double dt = (double)t[n - 1] - t0v;
  if (dt == 0) dt = 1.0;
  const double tscale = (C - 1) / dt;
  const int64_t HW = (int64_t)H * W;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t xi = xs[i], yi = ys[i];
    if (xi < 0 || xi >= W || yi < 0 || yi >= H) continue;
    const double ts = ((double)t[i] - t0v) * tscale;
    if (ts < 0 || ts >= C) continue;
    const int ti = (int)ts;
    const float dts = (float)(ts - ti);
    float pol = p[i];
    if (pol == 0.f) pol = -1.f;
    float* g = (pol == 1.f) ? grid_pos : grid_neg;
    const int64_t base = (int64_t)yi * W + xi;
    if (ti < C) g[ti * HW + base] += 1.f - dts;
    if (ti + 1 < C) g[(ti + 1) * HW + base] += dts;
  }
}

// 2-channel (neg, pos) event count histogram.
void event_histogram(
    const int64_t* xs, const int64_t* ys, const float* p,
    int64_t n, int H, int W, float* hist_neg, float* hist_pos) {
  for (int64_t i = 0; i < n; ++i) {
    const int64_t xi = xs[i], yi = ys[i];
    if (xi < 0 || xi >= W || yi < 0 || yi >= H) continue;
    float* h = (p[i] == 1.f || p[i] > 0.f) ? hist_pos : hist_neg;
    h[yi * W + xi] += 1.f;
  }
}

// Exact time-window boundary search on a sorted int64 timestamp slice
// (the numba get_time_indices_offsets contract, eventslicer.py:152-203):
// returns idx such that t[idx_start] >= t_start and t[idx_start-1] < t_start.
void time_indices_offsets(
    const int64_t* t, int64_t n, int64_t t_start, int64_t t_end,
    int64_t* idx_start, int64_t* idx_end) {
  *idx_start = std::lower_bound(t, t + n, t_start) - t;
  *idx_end = std::lower_bound(t, t + n, t_end) - t;
}

// ---------------------------------------------------------------------------
// Two-phase sorted-chunk wire packer for the sorted-chunk voxelizers K1/K4
// (openess_tpu_torch/ops/voxelize_chunked.py — see its module docstring
// for the format). Phase A computes per-window greedy chunk layouts (quantize +
// (16-row tile, x corner) histogram + greedy cuts) and reports how many
// chunks each window actually USES, so the Python wrapper can allocate the
// wire at a bucketed batch-max chunk count instead of the ~2.4x worst
// case. Phase B re-runs the cheap quantize (recompute beats storing: no
// [K]-sized scratch traffic) and counting-sort-places events
// into the trimmed wire, zero-filling only the padding tails.
//
// Bit-identical twin of the numpy `chunk_events_window` (round-half-even
// quantization via nearbyint; trunc-toward-zero corner from integer
// division); the trimmed wire equals the untrimmed wire's [:, :nbc] slice.
// Windows are distributed dynamically across threads in both phases.
// ---------------------------------------------------------------------------

namespace {

constexpr int kTile = 16, kFp = 32, kTileC = 128;

// Branchless per-block quantize: events [i0, i1) of one window -> quantized
// coords qx/qy (int32 fixed-point) and bucket key (or -1 dropped). Written
// array-style so -O3 -march=native autovectorizes it (AVX-512 on the
// training hosts); this is the packer's per-event hot arithmetic, run once
// per phase.
inline void quantize_block(
    const float* xw, const float* yw, const uint8_t* vw,
    int64_t i0, int64_t i1, int H, int W, int integer_coords,
    int32_t* qx, int32_t* qy, int32_t* key, uint8_t* tile) {
  const float xmax = (float)(W * kFp), ymax = (float)(H * kFp);
  const float xmin = integer_coords ? 0.f : (float)(-2 * kFp + 1);
  const float ymin = xmin;
  for (int64_t i = i0; i < i1; ++i) {
    const int64_t j = i - i0;
    // Quantize the fraction RELATIVE to trunc(x), clamped to +/-31/32, so
    // the dequantized coord keeps the original trunc-toward-zero corner
    // pair exactly (the reference weight function is discontinuous at
    // negative integers — see chunk_events_window). All f32 steps are
    // exact (trunc, Sterbenz subtraction, *32 mantissa shift), so
    // round-half-even matches the numpy float64 reference bit for bit.
    const float tx = std::trunc(xw[i]);
    const float ty = std::trunc(yw[i]);
    float fx = std::nearbyintf((xw[i] - tx) * (float)kFp);
    float fy = std::nearbyintf((yw[i] - ty) * (float)kFp);
    fx = tx * (float)kFp +
         std::min(std::max(fx, (float)(1 - kFp)), (float)(kFp - 1));
    fy = ty * (float)kFp +
         std::min(std::max(fy, (float)(1 - kFp)), (float)(kFp - 1));
    fx = std::min(std::max(fx, -32768.f), 32767.f);
    fy = std::min(std::max(fy, -32768.f), 32767.f);
    const int32_t xi = (int32_t)fx, yi = (int32_t)fy;
    const bool keep = vw[i] && fx >= xmin && fx < xmax && fy >= ymin &&
                      fy < ymax;
    const int32_t y0 = yi / kFp;  // trunc toward zero (torch .int())
    const int32_t x0 = xi / kFp;
    const int32_t yt = std::min(std::max(y0, 0), H - 1) / kTile;
    const int32_t xc = std::min(std::max(x0, 0), W - 1);
    qx[j] = xi;
    qy[j] = yi;
    key[j] = keep ? yt * W + xc : -1;
    tile[j] = (uint8_t)yt;
  }
}

constexpr int64_t kBlock = 4096;  // quantize-block temps stay L1/L2 resident

}  // namespace

// Phase A: per-window greedy chunk layout. Outputs (all caller-allocated):
//   key_pos  int32 [n_win, n_key+1]  per-bucket global slot cursors (phase B
//            consumes and mutates them); n_key = ceil(H/16) * W
//   counts_o int32 [n_win, nbc_cap]  events per chunk
//   r0_o     int32 [n_win, nbc_cap]  packed descriptors (row | col << 16)
//   tfirst_o f64   [n_win]           window-first valid timestamp
//   trange_o f32   [n_win]           wire time range (>= 1 fallback)
//   used_o   int32 [n_win]           chunks actually used (<= nbc_cap)
void chunk_events_phase_a(
    const float* x, const float* y, const float* p, const double* t,
    const uint8_t* valid, int64_t n_win, int64_t K,
    int H, int W, int chunk, int nbc_cap, int integer_coords,
    int32_t* key_pos, int32_t* counts_o, int32_t* r0_o,
    double* tfirst_o, float* trange_o, int32_t* used_o, int n_threads) {
  (void)p;
  const int n_tiles = (H + kTile - 1) / kTile;
  const int64_t n_key = (int64_t)n_tiles * W;
  if (n_threads <= 0) n_threads = (int)std::thread::hardware_concurrency();
  n_threads = (int)std::min<int64_t>(std::max(n_threads, 1), n_win);

  std::atomic<int64_t> next(0);
  auto work = [&]() {
    std::vector<int32_t> qx(kBlock), qy(kBlock), key(kBlock);
    std::vector<uint8_t> tile(kBlock);
    for (;;) {
      const int64_t w = next.fetch_add(1);
      if (w >= n_win) return;
      const float* xw = x + w * K;
      const float* yw = y + w * K;
      const double* tw = t + w * K;
      const uint8_t* vw = valid + w * K;
      int32_t* kp = key_pos + w * (n_key + 1);
      int32_t* cntw = counts_o + w * nbc_cap;
      int32_t* r0w = r0_o + w * nbc_cap;

      // t range over ALL valid events (incl. any dropped out-of-frame ones —
      // dropping must not shift t_first/t_last)
      double t_first = 0, t_last = 0;
      bool any_valid = false;
      for (int64_t i = 0; i < K; ++i) {
        if (!vw[i]) continue;
        const double ti = tw[i];
        if (!any_valid) { t_first = t_last = ti; any_valid = true; }
        else { t_first = std::min(t_first, ti); t_last = std::max(t_last, ti); }
      }
      tfirst_o[w] = t_first;
      trange_o[w] = any_valid
          ? (float)std::max(t_last - t_first, 1.0 * (t_last == t_first))
          : 1.f;
      if (trange_o[w] <= 0.f) trange_o[w] = 1.f;

      // histogram of (16-row tile, x corner) keys
      std::memset(kp, 0, (n_key + 1) * sizeof(int32_t));
      int32_t* hist = kp + 1;
      for (int64_t i0 = 0; i0 < K; i0 += kBlock) {
        const int64_t i1 = std::min(i0 + kBlock, K);
        quantize_block(xw, yw, vw, i0, i1, H, W, integer_coords,
                       qx.data(), qy.data(), key.data(), tile.data());
        for (int64_t j = 0; j < i1 - i0; ++j) {
          const int32_t k = key[j];
          if (k >= 0) ++hist[k];
        }
      }

      // greedy chunk layout straight from the histogram. Within a row tile
      // the sorted run's x corner is monotone, so a chunk is cut when its
      // events would overflow the kernel's lane block ([c0, c0+2*128) incl.
      // the +1 x-corner spill for trilinear; [c0, c0+128) exact for integer
      // coords), the row tile changes, or the chunk fills (capacity cuts
      // re-anchor c0, matching the numpy reference). A bucket's events land
      // in globally CONSECUTIVE wire slots (capacity continuations are
      // adjacent chunks packed from 0), so kp[k] becomes the bucket's
      // running slot cursor and phase B is one stable counting-sort write.
      // nbc_cap from num_chunks() provably suffices; the guards drop (never
      // write OOB) on a too-small cap.
      for (int c = 0; c < nbc_cap; ++c) { cntw[c] = 0; r0w[c] = 0; }
      const int32_t span = integer_coords ? kTileC : 2 * kTileC - 1;
      const int64_t cap_end = (int64_t)nbc_cap * chunk;
      int32_t cchunk = -1, in_chunk = 0, c0 = 0, prev_yt = -1;
      bool exhausted = false;
      for (int64_t k = 0; k < n_key; ++k) {
        const int32_t cnt = hist[k];  // bucket count (pre-prefix)
        if (cnt == 0) continue;
        if (exhausted) { kp[k] = -1; continue; }
        const int32_t yt = (int32_t)(k / W);
        const int32_t x0b = (int32_t)(k % W);  // clipped x corner
        if (cchunk < 0 || yt != prev_yt || x0b - c0 >= span ||
            in_chunk >= chunk) {
          if (cchunk + 1 >= nbc_cap) { exhausted = true; kp[k] = -1; continue; }
          ++cchunk;
          in_chunk = 0;
          prev_yt = yt;
          c0 = (x0b / kTileC) * kTileC;
          // packed descriptor: row offset | (col offset << 16)
          r0w[cchunk] = yt * kTile | (c0 << 16);
        }
        kp[k] = cchunk * chunk + in_chunk;  // bucket slot cursor
        int64_t rem = std::min<int64_t>(cnt, cap_end - kp[k]);
        if (rem < cnt) exhausted = true;
        while (rem > 0) {
          const int64_t put = std::min<int64_t>(rem, chunk - in_chunk);
          in_chunk += (int32_t)put;
          rem -= put;
          cntw[cchunk] = in_chunk;
          if (in_chunk >= chunk && rem > 0) {
            ++cchunk;  // capacity continuation (< nbc_cap by the rem cap)
            in_chunk = 0;
            c0 = (x0b / kTileC) * kTileC;  // re-anchor, as numpy does
            r0w[cchunk] = prev_yt * kTile | (c0 << 16);
          }
        }
      }
      // padding chunks repeat the last chunk's descriptor
      for (int32_t c = std::max(cchunk, 0) + 1; c < nbc_cap; ++c)
        r0w[c] = r0w[std::max(cchunk, 0)];
      used_o[w] = cchunk + 1;
    }
  };
  std::vector<std::thread> threads;
  for (int ti = 1; ti < n_threads; ++ti) threads.emplace_back(work);
  work();
  for (auto& th : threads) th.join();
}

// Phase B: stable counting-sort placement into the trimmed wire
// [n_win, nbc, chunk] (nbc >= batch-max used_o from phase A; smaller values
// drop the tail chunks, never write OOB). Re-runs the vectorized quantize
// (cheaper than storing per-event scratch), consumes/mutates phase A's
// key_pos cursors, and zero-fills exactly the padding slots (chunk tails
// past counts_o and whole unused chunks), so the wire is deterministic and
// equals the numpy reference's zero-padded layout. counts_o is read at
// stride nbc_cap (phase A's layout), first nbc entries per window.
//
// t16 != 0 selects the v2 time wire: tr_o holds uint16 instead of f32, the
// relative time quantized against phase A's trange_o (round-half-even,
// t_rel/t_range * 65535). All steps are f32 with the same op order as the
// numpy reference, so the two packers stay bit-identical. Worst-case time
// error is t_range/131070 (~0.4 us of a 50 ms window) — two orders below
// the reference's own f32 cast of ABSOLUTE us timestamps (~64 us ulp at
// 1e9 us, DSEC/dataset/representations.py:24).
void chunk_events_phase_b(
    const float* x, const float* y, const float* p, const double* t,
    const uint8_t* valid, int64_t n_win, int64_t K,
    int H, int W, int chunk, int nbc, int nbc_cap, int integer_coords,
    int32_t* key_pos, const int32_t* counts_o, const double* tfirst_o,
    const float* trange_o, int16_t* xq_o, int16_t* yq_o, uint8_t* pq_o,
    void* tr_o, int t16, int n_threads) {
  const int n_tiles = (H + kTile - 1) / kTile;
  const int64_t n_key = (int64_t)n_tiles * W;
  if (n_threads <= 0) n_threads = (int)std::thread::hardware_concurrency();
  n_threads = (int)std::min<int64_t>(std::max(n_threads, 1), n_win);

  std::atomic<int64_t> next(0);
  auto work = [&]() {
    std::vector<int32_t> qx(kBlock), qy(kBlock), key(kBlock);
    std::vector<uint8_t> tile(kBlock), pq(kBlock);
    std::vector<float> trel(kBlock);
    for (;;) {
      const int64_t w = next.fetch_add(1);
      if (w >= n_win) return;
      const float* xw = x + w * K;
      const float* yw = y + w * K;
      const float* pw = p + w * K;
      const double* tw = t + w * K;
      const uint8_t* vw = valid + w * K;
      int32_t* kp = key_pos + w * (n_key + 1);
      const int32_t* cntw = counts_o + w * nbc_cap;
      const double t_first = tfirst_o[w];
      const int64_t wire_end = (int64_t)nbc * chunk;
      int16_t* xqw = xq_o + w * wire_end;
      int16_t* yqw = yq_o + w * wire_end;
      uint8_t* pqw = pq_o + w * wire_end;
      float* trw = t16 ? nullptr : (float*)tr_o + w * wire_end;
      uint16_t* tqw = t16 ? (uint16_t*)tr_o + w * wire_end : nullptr;
      // f32 division, matching np.float32(65535.0) / t_range in the
      // reference chunker (trange_o >= 1 fallback guarantees tscale finite)
      const float tscale = t16 ? 65535.0f / trange_o[w] : 0.f;

      for (int64_t i0 = 0; i0 < K; i0 += kBlock) {
        const int64_t i1 = std::min(i0 + kBlock, K);
        const int64_t n = i1 - i0;
        quantize_block(xw, yw, vw, i0, i1, H, W, integer_coords,
                       qx.data(), qy.data(), key.data(), tile.data());
        if (t16) {
          for (int64_t j = 0; j < n; ++j) {  // vectorizable
            const float tr32 = (float)(tw[i0 + j] - t_first);
            trel[j] = std::min(std::nearbyintf(tr32 * tscale), 65535.f);
            pq[j] = (uint8_t)(pw[i0 + j] > 0.f ? 1 : 0);
          }
        } else {
          for (int64_t j = 0; j < n; ++j) {  // vectorizable
            trel[j] = (float)(tw[i0 + j] - t_first);
            pq[j] = (uint8_t)(pw[i0 + j] > 0.f ? 1 : 0);
          }
        }
        for (int64_t j = 0; j < n; ++j) {
          // software prefetch: pull the cursor line and (via its slightly
          // stale value) the four wire lines ~16 events ahead — the
          // counting-sort scatter is L2-latency-bound without this
          if (j + 16 < n && key[j + 16] >= 0) {
            const int32_t kf = key[j + 16];
            const int64_t sf = kp[kf];
            __builtin_prefetch(&kp[kf], 1);
            if (sf >= 0 && sf < wire_end) {
              __builtin_prefetch(xqw + sf, 1);
              __builtin_prefetch(yqw + sf, 1);
              __builtin_prefetch(pqw + sf, 1);
              __builtin_prefetch(t16 ? (void*)(tqw + sf) : (void*)(trw + sf),
                                 1);
            }
          }
          const int32_t k = key[j];
          if (k < 0) continue;  // dropped/invalid event
          int32_t& cur = kp[k];
          if (cur < 0) continue;  // dropped bucket (too-small nbc_cap)
          const int64_t slot = cur++;
          if (slot >= wire_end) continue;  // trimmed/truncated bucket tail
          xqw[slot] = (int16_t)qx[j];
          yqw[slot] = (int16_t)qy[j];
          pqw[slot] = pq[j];
          if (t16) tqw[slot] = (uint16_t)trel[j];
          else trw[slot] = trel[j];
        }
      }

      // zero exactly the padding: per-chunk tails past counts, whole unused
      // chunks (deterministic wire; the device kernels mask by counts anyway)
      for (int c = 0; c < nbc; ++c) {
        const int32_t cnt = cntw[c];
        const int64_t off = (int64_t)c * chunk + cnt;
        const int64_t pad = chunk - cnt;
        if (pad <= 0) continue;
        std::memset(xqw + off, 0, pad * sizeof(int16_t));
        std::memset(yqw + off, 0, pad * sizeof(int16_t));
        std::memset(pqw + off, 0, pad * sizeof(uint8_t));
        if (t16) std::memset(tqw + off, 0, pad * sizeof(uint16_t));
        else std::memset(trw + off, 0, pad * sizeof(float));
      }
    }
  };
  std::vector<std::thread> threads;
  for (int ti = 1; ti < n_threads; ++ti) threads.emplace_back(work);
  work();
  for (auto& th : threads) th.join();
}

// Nonzero-mean/std normalization in place (biased, EventPreprocessor /
// data_util.py:38-48 semantics).
void normalize_nonzero_inplace(float* grid, int64_t n) {
  double sum = 0, sq = 0;
  int64_t cnt = 0;
  for (int64_t i = 0; i < n; ++i) {
    const float v = grid[i];
    if (v != 0.f) { sum += v; sq += (double)v * v; ++cnt; }
  }
  if (cnt == 0) return;
  const double mean = sum / cnt;
  const double var = sq / cnt - mean * mean;
  const double std = var > 0 ? std::sqrt(var) : 0.0;
  if (std == 0) return;
  const float m = (float)mean, inv = (float)(1.0 / std);
  for (int64_t i = 0; i < n; ++i) {
    if (grid[i] != 0.f) grid[i] = (grid[i] - m) * inv;
  }
}

}  // extern "C"

// Fused swish -> depthwise 5x5 convolution (+ bias) for Hopper: the forward
// and both halves of its backward.
//
// Replaces the TPU kernels of nvae_tpu/kernels/depthwise.py:
// - dw5x5_stencil<kSwish, kBias, false, false>: _fused_fwd_kernel (launched
//   by _make_fused_dw.fwd_call) and, with swish and bias off, the plain
//   _dw_kernel behind depthwise_conv5x5.  It computes
//     y[b, h, w, c] = sum_{dy, dx} s(x)[b, h + dy - 2, w + dx - 2, c] * k[dy, dx, c]
//                     (+ bias[c])
//   with s = swish or the identity, SAME zero padding, NHWC fp32 in and out.
// - dw5x5_stencil<false, false, true, kSwishGrad>: _fused_dx_kernel and
//   _fused_dx_nox_kernel (launched by _make_fused_dw.dx_call), the same
//   stencil over dy with the taps flipped, k[4 - dy, 4 - dx, c], times
//     swish'(x) = sig(x) * (1 + x * (1 - sig(x)))
//   read at the output position; the nox form (kSwishGrad off) never reads x.
// - dw5x5_dw_partial<kSwish> + dw5x5_dw_reduce: _fused_dw_kernel (launched by
//   _make_fused_dw.dw_call),
//     dW[dy, dx, c] = sum_{b, h, w} s(x)[b, h + dy - 2, w + dx - 2, c] * g[b, h, w, c]
//     db[c]         = sum_{b, h, w} g[b, h, w, c]
//   in fp32.
//
// What bounds them on the card: HBM bytes.  The stencils do 25 multiply-adds
// (50 FLOP) per output against 8 bytes of device memory (12 with the
// swish' epilogue, which reads x too), under 7 FLOP per byte, far below the
// H100's fp32 ridge of 67 TFLOP/s over 3.35 TB/s = 20 FLOP per byte.  dW/db
// does 25 multiply-adds per element of x against 8 bytes (x and g read once),
// also under 7 FLOP per byte.  Each input element read once and each output
// element written once is the bound.
//
// Stencil design: one block per (batch row, tile of up to kTileH = 8 output
// rows, chunk of 32 channels).  The 4x4 and 8x8 planes of the generative
// cells are one tile; the 16x16 and 32x32 postprocess planes are 2 and 4.  A
// whole 32x32 plane per block would need 166 KB of shared memory, one block
// per SM, whose loads and arithmetic never overlap; a tile needs at most
// 58 KB, so several blocks share an SM.
// - The chunk's 25 x 32 taps are staged in shared memory with coalesced
//   loads for either weight layout (channel-fastest, as JAX stores it, or
//   taps-fastest, as a (C, 1, 5, 5) PyTorch weight is), then each thread
//   keeps its channel's 25 taps (flipped for dx) and its bias in registers.
// - The block reads the tile's input rows plus a 2-row halo from NHWC memory
//   (32 neighbouring channels are one 128-byte line per pixel, read by one
//   warp; each thread issues kLoads independent loads before it stores any),
//   applies swish, and keeps them zero-padded in shared memory as a
//   (th + 4) x (W + 4) x 32 fp32 tile: at most 12 x 36 x 32 x 4 B = 55 KB.
//   Halo rows are read twice, from L2 for the most part.
// - Each thread owns one channel and walks strips of kStrip output rows in
//   one column: each staged row of the strip is read from shared memory once
//   (5 values) and feeds every accumulator it touches, so a strip of 4
//   outputs costs 8 x 5 = 40 shared loads instead of 100.
// Every output sums its taps in fp32 in the order dy-major, dx-minor, as the
// TPU kernels do, and the bias (or the swish' factor) comes last.
//
// dW/db design: the TPU kernel keeps its (25, C-block) output resident in
// VMEM across a sequential grid axis over batch tiles.  Hopper runs blocks in
// no order, so the reduction takes two launches and no atomics, and two runs
// on the same input give the same bits:
// - dw5x5_dw_partial: grid (32-channel chunk, n_parts).  Block y walks the
//   (batch row, row tile) units y, y + n_parts, ... in order; for each it
//   stages s(x) with its halo as the stencil does, and each thread (one
//   channel) walks strips of output positions, reading the strip's g values
//   straight from HBM (each is read once) and keeping 25 tap sums and the
//   bias sum in registers.  At the end the warps' sums are added in shared
//   memory in warp order and the block writes one (26, 32) slice of the
//   (n_parts, 26, C) partials buffer.
// - dw5x5_dw_reduce: one thread per (tap or bias, channel) adds the n_parts
//   partials in order into dW (25, C) and db (C).
// Shared-memory rows are 32 floats wide (25 for the taps), so a warp's
// accesses hit 32 distinct banks.
// What holds the stencils back (PERF.md): about 10 shared loads and a dozen
// index instructions per output on top of its 25 FMAs, and a block that
// stages, then computes, with nothing in flight in between.

#include <cuda_runtime.h>

namespace {

constexpr int kTaps = 5;
constexpr int kTaps2 = kTaps * kTaps;
constexpr int kSums = kTaps2 + 1;  // 25 tap sums and the bias sum
constexpr int kPad = 2;
constexpr int kChunk = 32;     // channels per block, one per lane of a warp
constexpr int kStrip = 4;      // output rows per thread item
constexpr int kTileH = 8;      // output rows per block, at most
constexpr int kMaxWarps = 8;   // warps per block
constexpr int kLoads = 8;      // global loads in flight per thread (staging)

__device__ __forceinline__ float sigmoid(float v) {
  return 1.0f / (1.0f + expf(-v));
}

__device__ __forceinline__ float swish(float v) { return v * sigmoid(v); }

__device__ __forceinline__ float swish_grad(float v) {
  const float s = sigmoid(v);
  return s * (1.0f + v * (1.0f - s));
}

// Zero the padding columns of a (th + 4) x (W + 4) x 32 tile and stage rows
// h0 - 2 .. h0 + th + 1 of one image's channel column `src` (zero outside
// the image), through swish if kSwish.  Each thread visits pixels
// threadIdx.y + k * blockDim.y, row-major; (row, column) advance by
// (step / W, step % W) with one carry, so no division runs per element.
template <bool kSwish>
__device__ __forceinline__ void stage_tile(const float* __restrict__ src,
                                           float* plane, int H, int W, int C,
                                           int h0, int th, bool live) {
  const int lane = threadIdx.x;
  const int row_stride = (W + 2 * kPad) * kChunk;
  for (int r = threadIdx.y; r < th + 2 * kPad; r += blockDim.y) {
#pragma unroll
    for (int s = 0; s < kPad; ++s) {
      plane[r * row_stride + s * kChunk + lane] = 0.0f;
      plane[r * row_stride + (W + kPad + s) * kChunk + lane] = 0.0f;
    }
  }
  const int step = blockDim.y;
  const int step_r = step / W;
  const int step_c = step - step_r * W;
  const int n_stage = (th + 2 * kPad) * W;
  int sr = threadIdx.y / W;
  int sc = threadIdx.y - sr * W;
  for (int q0 = threadIdx.y; q0 < n_stage; q0 += kLoads * step) {
    float v[kLoads];
    int r = sr;
    int s = sc;
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int ih = h0 - kPad + r;
      const bool in = live && q0 + u * step < n_stage && ih >= 0 && ih < H;
      v[u] = in ? src[(size_t)(ih * W + s) * C] : 0.0f;
      r += step_r;
      s += step_c;
      if (s >= W) {
        s -= W;
        ++r;
      }
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      if (q0 + u * step < n_stage) {
        plane[sr * row_stride + (sc + kPad) * kChunk + lane] =
            kSwish ? swish(v[u]) : v[u];
      }
      sr += step_r;
      sc += step_c;
      if (sc >= W) {
        sc -= W;
        ++sr;
      }
    }
  }
}

// Forward (kFlip off) or dx (kFlip on) stencil; see the header.  `xres` is
// the pre-activation x read by the swish' epilogue (kSwishGrad), else unused.
template <bool kSwish, bool kBias, bool kFlip, bool kSwishGrad>
__global__ void __launch_bounds__(kChunk * kMaxWarps)
dw5x5_stencil(const float* __restrict__ x, const float* __restrict__ w,
              const float* __restrict__ bias, const float* __restrict__ xres,
              float* __restrict__ y, int H, int W, int C, int tile_h,
              long long w_stride_dy, long long w_stride_dx,
              long long w_stride_c) {
  extern __shared__ float smem[];
  float* wts = smem;                      // [kChunk][25]
  float* plane = smem + kChunk * kTaps2;  // [(tile_h + 4) * (W + 4)][kChunk]
  const int lane = threadIdx.x;
  const int tid = threadIdx.y * kChunk + lane;
  const int nthreads = blockDim.y * kChunk;
  const int c0 = blockIdx.x * kChunk;
  const int c = c0 + lane;
  const bool live = c < C;
  const int tiles = (H + tile_h - 1) / tile_h;
  const int row = blockIdx.y / tiles;                // batch row
  const int h0 = (blockIdx.y - row * tiles) * tile_h;  // first output row
  const int th = min(tile_h, H - h0);                // output rows here
  const int row_stride = (W + 2 * kPad) * kChunk;  // floats per staged row

  // Taps: consecutive threads take consecutive addresses of whichever
  // layout has a unit stride.
  const bool channel_fastest = w_stride_c == 1;
  for (int e = tid; e < kChunk * kTaps2; e += nthreads) {
    const int ln = channel_fastest ? e % kChunk : e / kTaps2;
    const int t = channel_fastest ? e / kChunk : e % kTaps2;
    const int cc = c0 + ln;
    wts[ln * kTaps2 + t] =
        cc < C ? w[(t / kTaps) * w_stride_dy + (t % kTaps) * w_stride_dx +
                   cc * w_stride_c]
               : 0.0f;
  }
  const size_t img = (size_t)row * H * W * C + c;
  stage_tile<kSwish>(x + img, plane, H, W, C, h0, th, live);
  __syncthreads();
  if (!live) return;  // no barrier follows
  // Flipping both tap axes maps tap dy * 5 + dx to 24 - (dy * 5 + dx).
  float tap[kTaps2];
#pragma unroll
  for (int t = 0; t < kTaps2; ++t) {
    tap[t] = wts[lane * kTaps2 + (kFlip ? kTaps2 - 1 - t : t)];
  }
  const float b = kBias ? bias[c] : 0.0f;
  float* yrow = y + img;

  // Items (strip, column), visited like the staged pixels.
  const int step = blockDim.y;
  const int step_r = step / W;
  const int step_c = step - step_r * W;
  const int strips = (th + kStrip - 1) / kStrip;
  int st = threadIdx.y / W;
  int ow = threadIdx.y - st * W;
  while (st < strips) {
    const int oh0 = st * kStrip;  // first output row of the strip, in tile
    const float* src = plane + oh0 * row_stride + ow * kChunk + lane;
    float acc[kStrip];
#pragma unroll
    for (int j = 0; j < kStrip; ++j) acc[j] = 0.0f;
#pragma unroll
    for (int r = 0; r < kStrip + kTaps - 1; ++r) {
      // Staged row oh0 + r feeds output row oh0 + j through tap row r - j.
      // Rows past the stage only occur in a ragged last strip, where they
      // feed outputs past the tile that are never stored.
      if (oh0 + r < th + 2 * kPad) {
        float v[kTaps];
#pragma unroll
        for (int dx = 0; dx < kTaps; ++dx) {
          v[dx] = src[r * row_stride + dx * kChunk];
        }
#pragma unroll
        for (int j = 0; j < kStrip; ++j) {
          const int dy = r - j;
          if (dy >= 0 && dy < kTaps) {
#pragma unroll
            for (int dx = 0; dx < kTaps; ++dx) {
              acc[j] = fmaf(v[dx], tap[dy * kTaps + dx], acc[j]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kStrip; ++j) {
      if (oh0 + j < th) {
        const size_t at = (size_t)((h0 + oh0 + j) * W + ow) * C;
        float out = kBias ? acc[j] + b : acc[j];
        if (kSwishGrad) out *= swish_grad(xres[img + at]);
        yrow[at] = out;
      }
    }
    st += step_r;
    ow += step_c;
    if (ow >= W) {
      ow -= W;
      ++st;
    }
  }
}

// Stage 1 of dW/db: per-block partial sums; see the header.
template <bool kSwish>
__global__ void __launch_bounds__(kChunk * kMaxWarps)
dw5x5_dw_partial(const float* __restrict__ x, const float* __restrict__ g,
                 float* __restrict__ partial, int H, int W, int C, int tile_h,
                 int units) {
  extern __shared__ float smem[];
  float* plane = smem;  // [(tile_h + 4) * (W + 4)][kChunk]
  float* red = smem + (tile_h + 2 * kPad) * (W + 2 * kPad) * kChunk;
  const int lane = threadIdx.x;
  const int c0 = blockIdx.x * kChunk;
  const int c = c0 + lane;
  const bool live = c < C;
  const int tiles = (H + tile_h - 1) / tile_h;
  const int row_stride = (W + 2 * kPad) * kChunk;
  const int step = blockDim.y;
  const int step_r = step / W;
  const int step_c = step - step_r * W;
  float acc[kSums];
#pragma unroll
  for (int t = 0; t < kSums; ++t) acc[t] = 0.0f;

  for (int unit = blockIdx.y; unit < units; unit += gridDim.y) {
    const int row = unit / tiles;
    const int h0 = (unit - row * tiles) * tile_h;
    const int th = min(tile_h, H - h0);
    const size_t img = (size_t)row * H * W * C + c;
    stage_tile<kSwish>(x + img, plane, H, W, C, h0, th, live);
    __syncthreads();
    if (live) {
      const float* grow = g + img;
      const int strips = (th + kStrip - 1) / kStrip;
      int st = threadIdx.y / W;
      int ow = threadIdx.y - st * W;
      while (st < strips) {
        const int oh0 = st * kStrip;
        float gv[kStrip];
#pragma unroll
        for (int j = 0; j < kStrip; ++j) {
          gv[j] = oh0 + j < th
                      ? grow[(size_t)((h0 + oh0 + j) * W + ow) * C]
                      : 0.0f;
        }
#pragma unroll
        for (int j = 0; j < kStrip; ++j) acc[kTaps2] += gv[j];
        const float* src = plane + oh0 * row_stride + ow * kChunk + lane;
#pragma unroll
        for (int r = 0; r < kStrip + kTaps - 1; ++r) {
          // Rows past the stage only meet outputs past the tile (g = 0).
          if (oh0 + r < th + 2 * kPad) {
            float v[kTaps];
#pragma unroll
            for (int dx = 0; dx < kTaps; ++dx) {
              v[dx] = src[r * row_stride + dx * kChunk];
            }
#pragma unroll
            for (int j = 0; j < kStrip; ++j) {
              const int dy = r - j;
              if (dy >= 0 && dy < kTaps) {
#pragma unroll
                for (int dx = 0; dx < kTaps; ++dx) {
                  acc[dy * kTaps + dx] =
                      fmaf(v[dx], gv[j], acc[dy * kTaps + dx]);
                }
              }
            }
          }
        }
        st += step_r;
        ow += step_c;
        if (ow >= W) {
          ow -= W;
          ++st;
        }
      }
    }
    __syncthreads();  // the next unit overwrites the plane
  }

  // The warps' sums, added in warp order.
#pragma unroll
  for (int t = 0; t < kSums; ++t) {
    red[(threadIdx.y * kSums + t) * kChunk + lane] = acc[t];
  }
  __syncthreads();
  const int tid = threadIdx.y * kChunk + lane;
  for (int e = tid; e < kSums * kChunk; e += blockDim.y * kChunk) {
    const int t = e / kChunk;
    const int ln = e - t * kChunk;
    float s = 0.0f;
    for (int wp = 0; wp < blockDim.y; ++wp) s += red[(wp * kSums + t) * kChunk + ln];
    if (c0 + ln < C) {
      partial[((size_t)blockIdx.y * kSums + t) * C + c0 + ln] = s;
    }
  }
}

// Stage 2 of dW/db: partials (n_parts, 26, C) summed in order.
__global__ void dw5x5_dw_reduce(const float* __restrict__ partial,
                                float* __restrict__ dw, float* __restrict__ db,
                                int C, int n_parts) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= kSums * C) return;
  const size_t stride = (size_t)kSums * C;
  float s = 0.0f;
#pragma unroll 8
  for (int i = 0; i < n_parts; ++i) s += partial[i * stride + e];
  if (e < kTaps2 * C) {
    dw[e] = s;
  } else if (db != nullptr) {
    db[e - kTaps2 * C] = s;
  }
}

int tile_rows(int H) { return H < kTileH ? H : kTileH; }

// Warps per block: one per (strip, column) item of a full tile, at most 8.
int warps_for(int tile_h, int W) {
  const int items = ((tile_h + kStrip - 1) / kStrip) * W;
  return items < kMaxWarps ? items : kMaxWarps;
}

template <bool kSwish, bool kBias, bool kFlip, bool kSwishGrad>
cudaError_t launch_stencil(const float* x, const float* w, const float* bias,
                           const float* xres, float* y, int batch, int H,
                           int W, int C, long long sdy, long long sdx,
                           long long sc, cudaStream_t stream) {
  const int tile_h = tile_rows(H);
  const int tiles = (H + tile_h - 1) / tile_h;
  const size_t smem =
      (kChunk * kTaps2 + (size_t)(tile_h + 2 * kPad) * (W + 2 * kPad) * kChunk) *
      sizeof(float);
  auto kernel = dw5x5_stencil<kSwish, kBias, kFlip, kSwishGrad>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((C + kChunk - 1) / kChunk, batch * tiles);
  const dim3 block(kChunk, warps_for(tile_h, W));
  kernel<<<grid, block, smem, stream>>>(x, w, bias, xres, y, H, W, C, tile_h,
                                        sdy, sdx, sc);
  return cudaGetLastError();
}

template <bool kSwish>
cudaError_t launch_dw(const float* x, const float* g, float* partial,
                      float* dw, float* db, int batch, int H, int W, int C,
                      int n_parts, cudaStream_t stream) {
  const int tile_h = tile_rows(H);
  const int units = batch * ((H + tile_h - 1) / tile_h);
  const int warps = warps_for(tile_h, W);
  const size_t smem = ((size_t)(tile_h + 2 * kPad) * (W + 2 * kPad) * kChunk +
                       (size_t)warps * kSums * kChunk) *
                      sizeof(float);
  auto kernel = dw5x5_dw_partial<kSwish>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((C + kChunk - 1) / kChunk, n_parts);
  kernel<<<grid, dim3(kChunk, warps), smem, stream>>>(x, g, partial, H, W, C,
                                                      tile_h, units);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int threads = 256;
  const int blocks = (kSums * C + threads - 1) / threads;
  dw5x5_dw_reduce<<<blocks, threads, 0, stream>>>(partial, dw, db, C, n_parts);
  return cudaGetLastError();
}

bool bad_shape(int batch, int H, int W, int C) {
  return batch <= 0 || H <= 0 || W <= 0 || C <= 0 ||
         (long long)batch * ((H + kTileH - 1) / kTileH) > 65535;
}

}  // namespace

// x, y: (batch, H, W, C) contiguous fp32.  w: fp32 taps, element (dy, dx, c)
// at w + dy * sdy + dx * sdx + c * sc.  bias: (C,) fp32 or null.
// Launches on `stream` of `device` and returns the cudaError_t of the launch.
extern "C" int nvae_dw5x5_fwd(const void* x, const void* w, const void* bias,
                              void* y, int batch, int H, int W, int C,
                              long long sdy, long long sdx, long long sc,
                              int fuse_swish, int device, void* stream) {
  if (bad_shape(batch, H, W, C)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(bias);
  float* yf = static_cast<float*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fuse_swish) {
    err = bf ? launch_stencil<true, true, false, false>(
                   xf, wf, bf, nullptr, yf, batch, H, W, C, sdy, sdx, sc, s)
             : launch_stencil<true, false, false, false>(
                   xf, wf, bf, nullptr, yf, batch, H, W, C, sdy, sdx, sc, s);
  } else {
    err = bf ? launch_stencil<false, true, false, false>(
                   xf, wf, bf, nullptr, yf, batch, H, W, C, sdy, sdx, sc, s)
             : launch_stencil<false, false, false, false>(
                   xf, wf, bf, nullptr, yf, batch, H, W, C, sdy, sdx, sc, s);
  }
  return (int)err;
}

// dx of the fused op.  dy, dx: (batch, H, W, C) contiguous fp32; w: the
// forward's taps with strides as above; x: the forward's (batch, H, W, C)
// input for the swish' epilogue, or null for the form without swish.
extern "C" int nvae_dw5x5_dx(const void* dy, const void* w, const void* x,
                             void* dx, int batch, int H, int W, int C,
                             long long sdy, long long sdx, long long sc,
                             int device, void* stream) {
  if (bad_shape(batch, H, W, C)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const float* gf = static_cast<const float*>(dy);
  const float* wf = static_cast<const float*>(w);
  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(dx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = xf ? launch_stencil<false, false, true, true>(
                 gf, wf, nullptr, xf, of, batch, H, W, C, sdy, sdx, sc, s)
           : launch_stencil<false, false, true, false>(
                 gf, wf, nullptr, nullptr, of, batch, H, W, C, sdy, sdx, sc, s);
  return (int)err;
}

// dW/db of the fused op, in two launches.  x, dy: (batch, H, W, C)
// contiguous fp32; partial: (n_parts, 26, C) fp32 scratch, 1 <= n_parts <=
// 65535; dw: (25, C) fp32, tap dy * 5 + dx first; db: (C,) fp32 or null.
extern "C" int nvae_dw5x5_dw(const void* x, const void* dy, void* partial,
                             void* dw, void* db, int batch, int H, int W,
                             int C, int n_parts, int fuse_swish, int device,
                             void* stream) {
  if (bad_shape(batch, H, W, C) || n_parts < 1 || n_parts > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const float* xf = static_cast<const float*>(x);
  const float* gf = static_cast<const float*>(dy);
  float* pf = static_cast<float*>(partial);
  float* wf = static_cast<float*>(dw);
  float* bf = static_cast<float*>(db);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = fuse_swish
            ? launch_dw<true>(xf, gf, pf, wf, bf, batch, H, W, C, n_parts, s)
            : launch_dw<false>(xf, gf, pf, wf, bf, batch, H, W, C, n_parts, s);
  return (int)err;
}

extern "C" const char* nvae_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Fused swish -> depthwise 5x5 convolution (+ bias), forward, for Hopper.
//
// Replaces the TPU kernel nvae_tpu/kernels/depthwise.py:_fused_fwd_kernel
// (launched by _make_fused_dw.fwd_call) and, with swish and bias off, the
// plain _dw_kernel behind depthwise_conv5x5.  It computes
//     y[b, h, w, c] = sum_{dy, dx} s(x)[b, h + dy - 2, w + dx - 2, c] * k[dy, dx, c]
//                     (+ bias[c])
// with s = swish or the identity, SAME zero padding, NHWC fp32 in and out.
//
// What bounds it on the card: each output takes 25 multiply-adds (50 FLOP)
// against 8 bytes of device memory (one fp32 read, one fp32 write), about 6
// FLOP per byte, far under the H100's fp32 ridge of 67 TFLOP/s over
// 3.35 TB/s = 20 FLOP per byte.  The bound is HBM bytes: each input element
// read once and each output element written once.
//
// Design: one block per (batch row, tile of up to kTileH = 8 output rows,
// chunk of 32 channels).  The 4x4 and 8x8 planes of the generative cells are
// one tile; the 16x16 and 32x32 postprocess planes are 2 and 4.  A whole
// 32x32 plane per block would need 166 KB of shared memory, one block per
// SM, whose loads and arithmetic never overlap; a tile needs at most 58 KB,
// so several blocks share an SM.
// - The chunk's 25 x 32 taps are staged in shared memory with coalesced
//   loads for either weight layout (channel-fastest, as JAX stores it, or
//   taps-fastest, as a (C, 1, 5, 5) PyTorch weight is), then each thread
//   keeps its channel's 25 taps and its bias in registers.
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
// TPU kernel does, and the bias comes last.  Shared-memory rows are 32 floats
// wide (25 for the taps), so a warp's accesses hit 32 distinct banks.
// What holds it back (PERF.md): about 10 shared loads and a dozen index
// instructions per output on top of its 25 FMAs, and a block that stages,
// then computes, with nothing in flight in between.

#include <cuda_runtime.h>

namespace {

constexpr int kTaps = 5;
constexpr int kTaps2 = kTaps * kTaps;
constexpr int kPad = 2;
constexpr int kChunk = 32;     // channels per block, one per lane of a warp
constexpr int kStrip = 4;      // output rows per thread item
constexpr int kTileH = 8;      // output rows per block, at most
constexpr int kMaxWarps = 8;   // warps per block
constexpr int kLoads = 8;      // global loads in flight per thread (staging)

__device__ __forceinline__ float swish(float v) {
  return v * (1.0f / (1.0f + expf(-v)));
}

template <bool kSwish, bool kBias>
__global__ void __launch_bounds__(kChunk * kMaxWarps)
dw5x5_fwd(const float* __restrict__ x, const float* __restrict__ w,
          const float* __restrict__ bias, float* __restrict__ y, int H, int W,
          int C, int tile_h, long long w_stride_dy, long long w_stride_dx,
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
  const int Wp = W + 2 * kPad;
  const int row_stride = Wp * kChunk;  // floats per staged row

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
  // The left and right padding columns.
  for (int r = threadIdx.y; r < th + 2 * kPad; r += blockDim.y) {
#pragma unroll
    for (int s = 0; s < kPad; ++s) {
      plane[r * row_stride + s * kChunk + lane] = 0.0f;
      plane[r * row_stride + (W + kPad + s) * kChunk + lane] = 0.0f;
    }
  }
  // Stage swish(x) of input rows h0 - 2 .. h0 + th + 1 (zero outside the
  // image).  Each thread visits pixels threadIdx.y + k * blockDim.y,
  // row-major; (row, column) advance by (step / W, step % W) with one carry,
  // so no division runs per element.
  const int step = blockDim.y;
  const int step_r = step / W;
  const int step_c = step - step_r * W;
  const float* xrow = x + (size_t)row * H * W * C + c;
  float* yrow = y + (size_t)row * H * W * C + c;
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
      v[u] = in ? xrow[(size_t)(ih * W + s) * C] : 0.0f;
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
  __syncthreads();
  if (!live) return;  // no barrier follows
  float tap[kTaps2];
#pragma unroll
  for (int t = 0; t < kTaps2; ++t) tap[t] = wts[lane * kTaps2 + t];
  const float b = kBias ? bias[c] : 0.0f;

  // Items (strip, column), visited like the pixels above.
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
        yrow[(size_t)((h0 + oh0 + j) * W + ow) * C] =
            kBias ? acc[j] + b : acc[j];
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

template <bool kSwish, bool kBias>
cudaError_t launch(const float* x, const float* w, const float* bias,
                   float* y, int batch, int H, int W, int C, long long sdy,
                   long long sdx, long long sc, cudaStream_t stream) {
  const int tile_h = H < kTileH ? H : kTileH;
  const int tiles = (H + tile_h - 1) / tile_h;
  const size_t smem =
      (kChunk * kTaps2 + (size_t)(tile_h + 2 * kPad) * (W + 2 * kPad) * kChunk) *
      sizeof(float);
  auto kernel = dw5x5_fwd<kSwish, kBias>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int items = ((tile_h + kStrip - 1) / kStrip) * W;
  const int warps = items < kMaxWarps ? items : kMaxWarps;
  const dim3 grid((C + kChunk - 1) / kChunk, batch * tiles);
  const dim3 block(kChunk, warps);
  kernel<<<grid, block, smem, stream>>>(x, w, bias, y, H, W, C, tile_h, sdy,
                                        sdx, sc);
  return cudaGetLastError();
}

}  // namespace

// x, y: (batch, H, W, C) contiguous fp32.  w: fp32 taps, element (dy, dx, c)
// at w + dy * sdy + dx * sdx + c * sc.  bias: (C,) fp32 or null.
// Launches on `stream` of `device` and returns the cudaError_t of the launch.
extern "C" int nvae_dw5x5_fwd(const void* x, const void* w, const void* bias,
                              void* y, int batch, int H, int W, int C,
                              long long sdy, long long sdx, long long sc,
                              int fuse_swish, int device, void* stream) {
  if (batch <= 0 || H <= 0 || W <= 0 || C <= 0 ||
      (long long)batch * ((H + kTileH - 1) / kTileH) > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(bias);
  float* yf = static_cast<float*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fuse_swish) {
    err = bf ? launch<true, true>(xf, wf, bf, yf, batch, H, W, C, sdy, sdx, sc, s)
             : launch<true, false>(xf, wf, bf, yf, batch, H, W, C, sdy, sdx, sc, s);
  } else {
    err = bf ? launch<false, true>(xf, wf, bf, yf, batch, H, W, C, sdy, sdx, sc, s)
             : launch<false, false>(xf, wf, bf, yf, batch, H, W, C, sdy, sdx, sc, s);
  }
  return (int)err;
}

extern "C" const char* nvae_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

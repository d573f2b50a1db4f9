// Fused squeeze-and-excitation gate for Hopper.
//
// Replaces the TPU kernel of nvae_tpu/kernels/se_gate.py: _se_kernel,
// launched by se_gate (pl.pallas_call at :53).  It computes
//   pooled[b, c] = sum_{h, w} x[b, h, w, c] / (H * W)
//   hidden[b, j] = relu(sum_c pooled[b, c] * w1[c, j] + b1[j])
//   gate[b, c]   = sigmoid(sum_j hidden[b, j] * w2[j, c] + b2[c])
//   y[b, h, w, c] = x[b, h, w, c] * gate[b, c]
// with x and y (B, H, W, C) NHWC fp32, w1 (C, Hd), b1 (Hd,), w2 (Hd, C),
// b2 (C,), all fp32 and contiguous.  Forward only, like the TPU kernel.
//
// What bounds it on the card: HBM bytes.  Per element of x it does one add
// (the pool) and one multiply (the gate) against 8 bytes (x read, y
// written); the two dense layers add 4 * C * Hd FLOP per batch row, a few
// per element at the model's shapes.  Each input read once and each output
// written once is the bound: 4.7 to 37.7 MB at the model's four SE shapes at
// batch 144, 1.4 to 11.3 us at 3.35 TB/s.
//
// Design: one block per batch row, as the TPU grid (grid=(b,)), of up to 32
// warps (one per pixel when H * W < 32).
// - Pass 1, pool: the block walks 32-channel chunks.  In a chunk, lane l
//   reads channel c0 + l and warp w the pixels w, w + nwarps, ..., so one
//   warp reads one 128-byte line per pixel.  Each thread adds its pixels in
//   order in a register; the warps' sums are added in warp order in shared
//   memory.  No atomics: two runs on the same input give the same bits.
// - Both dense layers run in the block's own threads, with pooled, hidden
//   and gate in shared memory.  Hidden unit j belongs to warp j mod nwarps,
//   whose lanes take channels l, l + 32, ... and meet in a fixed shuffle
//   tree; gate value c belongs to thread c mod nthreads, which adds the Hd
//   hidden terms in order.  The products are computed here, not by a
//   library call.
// - Pass 2: y = x * gate with the layout of pass 1, y written once.  x is
//   read a second time, from L2 for the most part: a batch row is at most
//   128 KB at the model's shapes and was read just before.  The TPU kernel
//   keeps the row in VMEM between the passes; a 128 KB row in shared memory
//   would leave one block per SM, and the model's batch of 144 rows would
//   run in two waves on 132 SMs.
// What holds it back (PERF.md): one block per batch row is 144 blocks, about
// one per SM, so each SM has at most 32 warps of loads in flight; and at the
// small planes (4x4, 8x8) the launch itself is most of the time.

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;
constexpr int kMaxWarps = 32;
constexpr unsigned kFullMask = 0xffffffffu;

__global__ void __launch_bounds__(kLanes * kMaxWarps)
se_gate_kernel(const float* __restrict__ x, const float* __restrict__ w1,
               const float* __restrict__ b1, const float* __restrict__ w2,
               const float* __restrict__ b2, float* __restrict__ y, int HW,
               int C, int Hd) {
  extern __shared__ float smem[];
  float* pooled = smem;         // [C]
  float* gate = pooled + C;     // [C]
  float* hidden = gate + C;     // [Hd]
  float* part = hidden + Hd;    // [nwarps][32]
  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int nwarps = blockDim.y;
  const int tid = warp * kLanes + lane;
  const int nthreads = nwarps * kLanes;
  const size_t row = (size_t)blockIdx.x * HW * C;
  const float* xr = x + row;
  float* yr = y + row;

  // Pass 1: per-channel sums over the H * W pixels, in a fixed order.
  for (int c0 = 0; c0 < C; c0 += kLanes) {
    const int c = c0 + lane;
    float s = 0.0f;
    if (c < C) {
#pragma unroll 4
      for (int p = warp; p < HW; p += nwarps) s += xr[(size_t)p * C + c];
    }
    part[warp * kLanes + lane] = s;
    __syncthreads();
    if (warp == 0 && c < C) {
      float t = 0.0f;
      for (int w = 0; w < nwarps; ++w) t += part[w * kLanes + lane];
      pooled[c] = t / (float)HW;
    }
    __syncthreads();
  }

  // Dense 1 with relu: one warp per hidden unit.
  for (int j = warp; j < Hd; j += nwarps) {
    float s = 0.0f;
    for (int c = lane; c < C; c += kLanes) s += pooled[c] * w1[(size_t)c * Hd + j];
#pragma unroll
    for (int off = kLanes / 2; off > 0; off >>= 1) {
      s += __shfl_down_sync(kFullMask, s, off);
    }
    if (lane == 0) hidden[j] = fmaxf(s + b1[j], 0.0f);
  }
  __syncthreads();

  // Dense 2 with sigmoid: one thread per channel.
  for (int c = tid; c < C; c += nthreads) {
    float s = 0.0f;
    for (int j = 0; j < Hd; ++j) s += hidden[j] * w2[(size_t)j * C + c];
    gate[c] = 1.0f / (1.0f + expf(-(s + b2[c])));
  }
  __syncthreads();

  // Pass 2: the gated map, written once.
  for (int c0 = 0; c0 < C; c0 += kLanes) {
    const int c = c0 + lane;
    if (c >= C) break;
    const float g = gate[c];
#pragma unroll 4
    for (int p = warp; p < HW; p += nwarps) {
      const size_t i = (size_t)p * C + c;
      yr[i] = xr[i] * g;
    }
  }
}

}  // namespace

// x, y: (batch, HW, C) contiguous fp32 (an NHWC map with H * W = HW);
// w1: (C, Hd), b1: (Hd,), w2: (Hd, C), b2: (C,), contiguous fp32.  Launches
// on `stream` of `device` and returns the cudaError_t of the launch.
extern "C" int nvae_se_gate(const void* x, const void* w1, const void* b1,
                            const void* w2, const void* b2, void* y,
                            int batch, int HW, int C, int Hd, int device,
                            void* stream) {
  if (batch <= 0 || HW <= 0 || C <= 0 || Hd <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int warps = HW < kMaxWarps ? HW : kMaxWarps;
  const size_t smem = (size_t)(2 * C + Hd + warps * kLanes) * sizeof(float);
  err = cudaFuncSetAttribute(se_gate_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  se_gate_kernel<<<batch, dim3(kLanes, warps), smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<float*>(y), HW, C, Hd);
  return (int)cudaGetLastError();
}

extern "C" const char* nvae_se_gate_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

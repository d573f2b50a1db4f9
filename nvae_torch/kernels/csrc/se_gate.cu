// Fused squeeze-and-excitation gate for Hopper: one thread block cluster per
// batch row.
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
// written); the dense layers add 4 * C * Hd FLOP per batch row.  At the
// model's four SE shapes at batch 144 the whole map is 2.4 to 18.9 MB: at
// most 143 KB per SM, so every row can be held on chip at once, read from
// HBM once and written once, as the TPU kernel does with its VMEM block.
//
// Design (geometry from nvae_torch/kernels/se_gate.py:geometry, a function of
// the shape alone, which the entry point holds to its own formula):
// - One cluster of k <= 8 blocks per batch row (grid B * k); block r of the
//   cluster owns the row's pixels [r HW / k, (r + 1) HW / k).
// - Read x once: one thread issues one bulk asynchronous copy
//   (cp.async.bulk, completed on an mbarrier) of the block's contiguous
//   pixel slice into shared memory, where it stays for the gate.  Where
//   C % 4 != 0 or x is not 16-byte aligned, every thread copies 4-byte
//   elements with cp.async instead.
// - w1, b1, w2 and b2 go to shared memory with cp.async at block entry and
//   arrive while x does.  Every block reads them whole, so the
//   geometry splits a row over k blocks only where a block's slice of x is
//   at least as large as the weights (k = 1 at 4x4x256, whose 32 KB of
//   weights outweigh its 16 KB row).
// - One exchange, pushed, of the first layer's sums: the layer is linear,
//   so each block applies it to its own pool sums while the others still
//   load, stores its Hd sums into every other block's shared memory with
//   st.async, which counts the bytes on the receiver's mbarrier, and waits
//   on its own mbarrier for the k - 1 rows sent to it; it adds the k rows
//   in rank order and computes the second layer itself, so all blocks hold
//   the same gate.  A cluster
//   barrier's first phase (arrive at entry, wait before the first store)
//   tells the blocks that the mbarriers are initialised; its second phase
//   (arrive once a block has received, wait before exit) keeps every block
//   alive until all stores have landed, and the dense layers and the gate
//   pass overlap it.
// - Sums in a fixed order, no atomics: each thread adds its pixels in
//   order, the thread groups are added in order, the ranks in order 0..k-1;
//   the dense layers' sums run over fixed index sets in fixed order.  Two
//   runs give the same bits.
// - y = x * gate from the copy on chip, written once with 16-byte stores
//   (4-byte where C % 4 != 0).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

namespace cg = cooperative_groups;

namespace {

// Threads per block: 128, or 256 where a cluster is one block (a whole row
// on one SM, with little else to run there).  Either way 1,280 threads an
// SM (48 registers a thread).
constexpr int kSmallBlock = 128;
constexpr int kLargeBlock = 256;
constexpr int kThreadsPerSm = 1280;
constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr int kMaxSmem = 232448;  // bytes of shared memory one block may use
// Two mbarriers before the floats: the slice's bulk copy, the exchange.
constexpr int kBarrierBytes = 16;
constexpr int kMaxDevices = 64;

long long round4(long long n) { return (n + 3) / 4 * 4; }

// Offsets, in floats after the mbarrier, of each array in a block's shared
// memory; every array starts on 16 bytes.  The same formula as
// _smem_bytes() in se_gate.py.  Computed on the host (in 64 bits, so that
// an absurd shape cannot wrap) and passed to the kernel as ints once the
// total is known to fit.
template <typename I>
struct Layout {
  I xs, red, part, w1, w2, b1, b2, hred, hpart, hidden, gate, floats;
};

Layout<long long> layout(long long HW, long long C, long long Hd,
                         long long k, long long threads) {
  const long long npix = (HW + k - 1) / k;  // the most pixels a block owns
  const long long unit = C % 4 == 0 ? 4 : 1;
  long long groups = threads / (C / unit);
  if (groups < 1) groups = 1;
  Layout<long long> L;
  L.xs = 0;                             // [npix][C] the pixel slice
  L.red = L.xs + round4(npix * C);      // [groups][C] thread-group sums
  L.part = L.red + round4(groups * C);  // [C] the block's pool sums
  L.w1 = L.part + round4(C);            // [C][Hd]
  L.w2 = L.w1 + round4(C * Hd);         // [Hd][C]
  L.b1 = L.w2 + round4(Hd * C);         // [Hd]
  L.b2 = L.b1 + round4(Hd);             // [C]
  // [Q][Hd] the first layer's sums over channel groups, Q Hd <= max(T, Hd)
  L.hred = L.b2 + round4(C);
  // [k][Hd] every block's first-layer sums
  L.hpart = L.hred + round4(Hd > threads ? Hd : threads);
  L.hidden = L.hpart + round4(k * Hd);  // [Hd]
  L.gate = L.hidden + round4(Hd);       // [C]
  L.floats = L.gate + round4(C);
  return L;
}

long long smem_bytes(int HW, int C, int Hd, int k, int threads) {
  return kBarrierBytes + 4 * layout(HW, C, Hd, k, threads).floats;
}

struct Args {
  const float* x;
  const float* w1;
  const float* b1;
  const float* w2;
  const float* b2;
  float* y;
  int HW, C, Hd, k;
  bool vec_in;
  Layout<int> L;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void copy4_async(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

// Wait until the mbarrier's first phase (parity 0) has completed.
__device__ __forceinline__ void wait_parity0(unsigned bar) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(0u)
        : "memory");
  }
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// This block's shared address `local` as block `rank` of the cluster sees it.
__device__ __forceinline__ unsigned map_rank(unsigned local, int rank) {
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(local), "r"(rank));
  return remote;
}

// Store v at `remote` (another block's shared memory) and count its 4 bytes
// on that block's mbarrier `remote_bar`.
__device__ __forceinline__ void send_async(unsigned remote, float v,
                                           unsigned remote_bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];\n" ::"r"(remote),
      "r"(__float_as_uint(v)), "r"(remote_bar)
      : "memory");
}

template <int kThreads>
__global__ void __launch_bounds__(kThreads, kThreadsPerSm / kThreads)
se_gate_cluster(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int HW = a.HW, C = a.C, Hd = a.Hd, k = a.k;
  const Layout<int>& L = a.L;
  float* base = reinterpret_cast<float*>(smem_raw + kBarrierBytes);
  float* xs = base + L.xs;
  float* red = base + L.red;
  float* part = base + L.part;
  float* w1s = base + L.w1;
  float* w2s = base + L.w2;
  float* b1s = base + L.b1;
  float* b2s = base + L.b2;
  float* hred = base + L.hred;
  float* hpart = base + L.hpart;
  float* hidden = base + L.hidden;
  float* gate = base + L.gate;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int t = threadIdx.x;
  // The slice fits shared memory, so 8 HW is far below 2^31.
  const int row = blockIdx.x / k;
  const int p0 = rank * HW / k;
  const int np = (rank + 1) * HW / k - p0;
  const size_t first = (static_cast<size_t>(row) * HW + p0) * C;
  const float* xr = a.x + first;
  float* yr = a.y + first;

  // The exchange's mbarrier expects the other blocks' first-layer sums,
  // (k - 1) Hd floats; the cluster barrier's first phase tells the other blocks that
  // it is initialised.
  const unsigned bar = smem_addr(smem_raw), xbar = bar + 8;
  if (k > 1 && t == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(xbar)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                     "r"(xbar),
                 "r"(static_cast<unsigned>(k - 1) * Hd * 4u)
                 : "memory");
  }
  if (k > 1) cluster_arrive();

  // Start every copy: the pixel slice, then the weights.
  if (a.vec_in && t == 0) {
    const unsigned bytes = static_cast<unsigned>(np) * C * 4u;
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                     "r"(bar),
                 "r"(bytes)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(xs)),
        "l"(xr), "r"(bytes), "r"(bar)
        : "memory");
  }
  if (!a.vec_in) {
    for (int i = t; i < np * C; i += kThreads) copy4_async(xs + i, xr + i);
  }
  for (int i = t; i < C * Hd; i += kThreads) copy4_async(w1s + i, a.w1 + i);
  for (int i = t; i < Hd * C; i += kThreads) copy4_async(w2s + i, a.w2 + i);
  for (int i = t; i < Hd; i += kThreads) copy4_async(b1s + i, a.b1 + i);
  for (int i = t; i < C; i += kThreads) copy4_async(b2s + i, a.b2 + i);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  __syncthreads();  // the mbarrier's init, before anyone waits on it
  if (a.vec_in) wait_parity0(bar);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // Pool: W units (float4 or float) per pixel; thread group g of S adds
  // pixels g, g + S, ... of the slice in order, then the groups in order.
  const int unit = C % 4 == 0 ? 4 : 1;
  const int W = C / unit;
  const int S = kThreads / W > 1 ? kThreads / W : 1;
  const int g = t / W;
  if (g < S) {
    for (int col = t - g * W; col < W; col += kThreads) {
      if (unit == 4) {
        float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 4
        for (int p = g; p < np; p += S) {
          const float4 v = reinterpret_cast<const float4*>(xs + p * C)[col];
          s.x += v.x;
          s.y += v.y;
          s.z += v.z;
          s.w += v.w;
        }
        reinterpret_cast<float4*>(red + g * C)[col] = s;
      } else {
        float s = 0.0f;
#pragma unroll 4
        for (int p = g; p < np; p += S) s += xs[p * C + col];
        red[g * C + col] = s;
      }
    }
  }
  __syncthreads();

  for (int c = t; c < C; c += kThreads) {
    float s = 0.0f;
    for (int q = 0; q < S; ++q) s += red[q * C + c];
    part[c] = s;
  }
  __syncthreads();

  // First layer on the block's own pool sums (it is linear, so the blocks'
  // results add up to the row's), on w1 as it lies ([C][Hd]): thread f of
  // the Q Hd takes hidden unit j = f mod Hd and channels q = f / Hd,
  // q + Q, ... in order, so a warp reads neighbouring words; then thread j
  // adds the Q sums in order, four running sums at a time.
  const int Q = kThreads / Hd > 1 ? kThreads / Hd : 1;
  for (int f = t; f < Q * Hd; f += kThreads) {
    const int q = f / Hd, j = f - q * Hd;
    float s = 0.0f;
#pragma unroll 4
    for (int c = q; c < C; c += Q) s += part[c] * w1s[c * Hd + j];
    hred[f] = s;
  }
  __syncthreads();

  // The exchange: thread j stores its sum in this block's row of `hpart`
  // and, with st.async, in the same row of every other block's, counted on
  // that block's mbarrier; then waits until the other rows have arrived and
  // adds the k rows in rank order.
  float* own = hpart + rank * Hd;
  if (k > 1) cluster_wait();  // every block's exchange mbarrier is ready
  for (int j = t; j < Hd; j += kThreads) {
    float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
    int q = 0;
    for (; q + 3 < Q; q += 4) {
      s0 += hred[q * Hd + j];
      s1 += hred[(q + 1) * Hd + j];
      s2 += hred[(q + 2) * Hd + j];
      s3 += hred[(q + 3) * Hd + j];
    }
    for (; q < Q; ++q) s0 += hred[q * Hd + j];
    const float s = (s0 + s1) + (s2 + s3);
    own[j] = s;
    for (int r = 0; r < k; ++r) {
      if (r != rank) {
        send_async(map_rank(smem_addr(own + j), r), s, map_rank(xbar, r));
      }
    }
  }
  if (k > 1) wait_parity0(xbar);
  for (int j = t; j < Hd; j += kThreads) {
    float s = 0.0f;
    for (int r = 0; r < k; ++r) s += hpart[r * Hd + j];
    hidden[j] = fmaxf(s / static_cast<float>(HW) + b1s[j], 0.0f);
  }
  // Every block's sums have reached this block; its own have reached the
  // others once all have arrived here (waited for before exit).
  if (k > 1) cluster_arrive();
  __syncthreads();

  // Second layer, one thread per channel: four running sums (hidden units
  // j mod 4), added in a fixed order.
  for (int c = t; c < C; c += kThreads) {
    const float* w = w2s + c;
    float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
    int j = 0;
    for (; j + 3 < Hd; j += 4) {
      s0 += hidden[j] * w[j * C];
      s1 += hidden[j + 1] * w[(j + 1) * C];
      s2 += hidden[j + 2] * w[(j + 2) * C];
      s3 += hidden[j + 3] * w[(j + 3) * C];
    }
    if (j < Hd) s0 += hidden[j] * w[j * C];
    if (j + 1 < Hd) s1 += hidden[j + 1] * w[(j + 1) * C];
    if (j + 2 < Hd) s2 += hidden[j + 2] * w[(j + 2) * C];
    const float z = (s0 + s1) + (s2 + s3) + b2s[c];
    gate[c] = __fdividef(1.0f, 1.0f + __expf(-z));
  }
  __syncthreads();

  // The gate, from the slice on chip; y written once.
  if (unit == 4) {
    const float4* xv = reinterpret_cast<const float4*>(xs);
    const float4* gv = reinterpret_cast<const float4*>(gate);
    // col = i mod W, stepped without a division.
    const int step = kThreads % W;
#pragma unroll 4
    for (int i = t, col = t % W; i < np * W;
         i += kThreads, col += step - (col + step >= W ? W : 0)) {
      const float4 gg = gv[col];
      float4 v = xv[i];
      v.x *= gg.x;
      v.y *= gg.y;
      v.z *= gg.z;
      v.w *= gg.w;
      reinterpret_cast<float4*>(yr)[i] = v;
    }
  } else {
    const int step = kThreads % C;
#pragma unroll 4
    for (int i = t, c = t % C; i < np * C;
         i += kThreads, c += step - (c + step >= C ? C : 0)) {
      yr[i] = xs[i] * gate[c];
    }
  }
  if (k > 1) cluster_wait();  // every store into this block has landed
}

// geo: {cluster size k, threads (128 or 256), shared bytes}.
bool bad_launch(const int* geo, int batch, int HW, int C, int Hd) {
  if (geo == nullptr || batch <= 0 || HW <= 0 || C <= 0 || Hd <= 0) {
    return true;
  }
  const int k = geo[0], threads = geo[1];
  return k < 1 || k > kMaxCluster || k > HW ||
         (threads != kSmallBlock && threads != kLargeBlock) ||
         geo[2] > kMaxSmem ||
         (long long)geo[2] != smem_bytes(HW, C, Hd, k, threads) ||
         (long long)batch * k > 0x7fffffffLL;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The kernel for a geometry's block size.
void (*kernel_for(const int* geo))(Args) {
  return geo[1] == kLargeBlock ? se_gate_cluster<kLargeBlock>
                               : se_gate_cluster<kSmallBlock>;
}

std::once_flag configured[kMaxDevices];
cudaError_t configure_error[kMaxDevices];

// Allow the largest dynamic shared memory once per process and device.
cudaError_t configure(int device) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  std::call_once(configured[device], [device] {
    cudaError_t err = cudaFuncSetAttribute(
        se_gate_cluster<kSmallBlock>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(se_gate_cluster<kLargeBlock>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kMaxSmem);
    }
    configure_error[device] = err;
  });
  return configure_error[device];
}

cudaLaunchConfig_t launch_config(int blocks, const int* geo,
                                 cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(static_cast<unsigned>(geo[1]));
  cfg.dynamicSmemBytes = static_cast<size_t>(geo[2]);
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = static_cast<unsigned>(geo[0]);
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// x, y: (batch, HW, C) contiguous fp32 (an NHWC map with H * W = HW);
// w1: (C, Hd), b1: (Hd,), w2: (Hd, C), b2: (C,), contiguous fp32; geo as
// se_gate.py's Geometry.c_array().  Launches batch clusters of geo[0]
// blocks on `stream` of `device` and returns the cudaError_t of the launch.
extern "C" int nvae_se_gate(const void* x, const void* w1, const void* b1,
                            const void* w2, const void* b2, void* y,
                            int batch, int HW, int C, int Hd, const int* geo,
                            int device, void* stream) {
  // y is stored with 16-byte stores where C % 4 == 0 (the wrapper
  // allocates it); x may lie anywhere.
  if (bad_launch(geo, batch, HW, C, Hd) || (C % 4 == 0 && !aligned16(y))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = configure(device);
  if (err != cudaSuccess) return (int)err;
  Args a;
  a.x = static_cast<const float*>(x);
  a.w1 = static_cast<const float*>(w1);
  a.b1 = static_cast<const float*>(b1);
  a.w2 = static_cast<const float*>(w2);
  a.b2 = static_cast<const float*>(b2);
  a.y = static_cast<float*>(y);
  a.HW = HW;
  a.C = C;
  a.Hd = Hd;
  a.k = geo[0];
  a.vec_in = C % 4 == 0 && aligned16(x);
  const Layout<long long> l = layout(HW, C, Hd, a.k, geo[1]);
  a.L = {(int)l.xs,   (int)l.red,   (int)l.part,   (int)l.w1,
         (int)l.w2,   (int)l.b1,    (int)l.b2,     (int)l.hred,
         (int)l.hpart, (int)l.hidden, (int)l.gate, (int)l.floats};
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = launch_config(batch * a.k, geo,
                                         static_cast<cudaStream_t>(stream),
                                         &attr);
  err = cudaLaunchKernelEx(&cfg, kernel_for(geo), a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// How many clusters of this geometry the card holds at once
// (cudaOccupancyMaxActiveClusters), into *out; returns the cudaError_t.
extern "C" int nvae_se_gate_max_active_clusters(int batch, int HW, int C,
                                                int Hd, const int* geo,
                                                int device, int* out) {
  if (bad_launch(geo, batch, HW, C, Hd) || out == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = configure(device);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = launch_config(batch * geo[0], geo, nullptr, &attr);
  return (int)cudaOccupancyMaxActiveClusters(out, kernel_for(geo), &cfg);
}

extern "C" const char* nvae_se_gate_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Fused swish -> depthwise 5x5 convolution (+ bias) for Hopper: the forward
// and both halves of its backward, on one streaming core.
//
// Replaces the TPU kernels of nvae_tpu/kernels/depthwise.py:
// - dw5x5_ring<kFwd, kSwish, kBias, false>: _fused_fwd_kernel (launched by
//   _make_fused_dw.fwd_call) and, with swish and bias off, the plain
//   _dw_kernel behind depthwise_conv5x5.  It computes
//     y[b, h, w, c] = sum_{dy, dx} s(x)[b, h + dy - 2, w + dx - 2, c] * k[dy, dx, c]
//                     (+ bias[c])
//   with s = swish or the identity, SAME zero padding, NHWC fp32 in and out.
//   Its bf16 instance (the Pallas kernel's semantics under
//   compute_dtype=bfloat16) is dw5x5_bf16<kFwd, ...>, the sliding-row
//   kernel below: it reads bf16 x and taps, applies swish and sums the 25
//   taps in fp32, adds an fp32 bias in fp32, and rounds y to bf16 once
//   (round to nearest even).
// - dw5x5_ring<kDx, false, false, kSwishGrad>: _fused_dx_kernel and
//   _fused_dx_nox_kernel (launched by _make_fused_dw.dx_call), the same
//   stencil over dy with the taps flipped, k[4 - dy, 4 - dx, c], times
//     swish'(x) = sig(x) * (1 + x * (1 - sig(x)))
//   read at the output position; the nox form (kSwishGrad off) never reads x.
//   Its bf16 instance is dw5x5_bf16<kDx, ...>, the sliding-row kernel: it
//   reads bf16 dy, x and taps, sums the 25 flipped taps in fp32, multiplies
//   by swish'(x) computed in fp32, and rounds dx to bf16 once.
// - dw5x5_ring<kDw, kSwish, false, false> + dw5x5_dw_reduce: _fused_dw_kernel
//   (launched by _make_fused_dw.dw_call),
//     dW[dy, dx, c] = sum_{b, h, w} s(x)[b, h + dy - 2, w + dx - 2, c] * g[b, h, w, c]
//     db[c]         = sum_{b, h, w} g[b, h, w, c]
//   in fp32.  Its bf16 instance (dw5x5_bf16<kDw, ...> + dw5x5_dw_reduce, the
//   sliding-row kernel) makes fp32 sums of the widened operands, as in fp32.
//
// What bounds them on the card: HBM bytes.  The stencils do 25 multiply-adds
// (50 FLOP) per output against 8 bytes of device memory (12 with the swish'
// epilogue, which reads x too), and dW/db 25 per element of x against 8
// bytes: under 7 FLOP per byte, far below the H100's fp32 ridge of 67
// TFLOP/s over 3.35 TB/s = 20 FLOP per byte.  No tensor cores: a depthwise
// 5x5 is a per-channel dot product of 25 terms, not a matrix product.  To
// run at the HBM rate the card needs enough bytes in flight: by Little's
// law 3.35 TB/s at about 1 us of loaded latency is ~3.4 MB over 132 SMs,
// about 25 KB of loads outstanding on every SM at all times.
//
// Design of the fp32 kernels: one streaming "row ring".
// - Persistent blocks on a fixed schedule.  Block i is channel chunk
//   i / parts (32 channels, one per lane) and walks the contiguous batch rows
//   [j * B / parts, (j + 1) * B / parts) of part j = i % parts, in order.
//   The launch geometry (parts, slots per pass G, passes ahead P, threads,
//   shared bytes) is computed on the host from the shape alone
//   (nvae_torch/kernels/depthwise.py, geometry()), so one shape gets one
//   schedule, and the same dW bits, on any card; the entry points check it
//   against their own shared-memory formula.  At most one wave of blocks.
// - The block's images form one stream of "slots": per image its H rows
//   with two zero rows above and two below (H + 4 slots).  Slot q lives in
//   ring row q % ((P + 1) G + 4), each (W' + 4) x 32 fp32 with W rounded up
//   to whole runs W'; the ring starts at zero and its pad columns stay so.
//   Output row r of an image needs slots r .. r + 4 of that image and is
//   computed in the pass that holds slot r + 4.  The stream crosses from one
//   image into the next without a break, so every input row is read from
//   HBM once: no re-staged halo.
// - Rows are filled with cp.async, a pass of G slots per commit group:
//   16-byte copies, eight lanes per pixel's 128-byte channel chunk (4-byte
//   copies where C % 4 != 0 or a pointer is not 16-byte aligned), the
//   zero-fill form (src-size 0) for halo rows and for channels past C.  The
//   copy mapping (a thread owns one pixel-segment column) is independent of
//   the compute mapping.  Right after the barrier that publishes pass p,
//   the block starts pass p + P into the rows pass p - 1 read, then
//   computes pass p: one __syncthreads per pass is all the ordering.  The
//   host sizes P and G for >= 8 KB of copies in flight per block, about
//   24 / 32 / 38 / 57 KB per SM at the 4x4 / 8x8 / 16x16 / 32x32 shapes.
// - Swish (forward, dW/db) is applied once per staged element, in place, by
//   the thread that copied it, after its cp.async.wait_group and before the
//   barrier that publishes the pass (__expf and __fdividef: a few ulp).
// - A second "aux" ring of (P + 1) G rows of W' x 32 fp32 carries, per
//   output row, the operand read at the output position: x for dx's swish'
//   epilogue (turned into swish'(x) in place by its copier) and g for
//   dW/db.  No kernel reads device memory synchronously while it computes.
// - Taps (flipped for dx) and the bias go to registers once per block.
// - Compute: an item is two adjacent output rows x a run of kRun = 4
//   outputs along W; a lane is one channel.  It reads 6 ring rows of 8
//   values from shared memory (32 lanes, 32 banks) for 8 outputs, 200 FMAs,
//   with no bounds checks (the pad).  Warp w takes items w, w + 8, ... of a
//   pass; a pass holds enough slots for one item per warp.  Outputs go
//   straight to HBM, 128 contiguous bytes per warp per pixel.  Every output
//   sums its taps in fp32 in the order dy-major, dx-minor, as the TPU
//   kernels do, and the bias (or the swish' factor) comes last.
// - dW/db: each thread keeps 25 tap sums and the bias sum for its channel
//   over all its items; at the end the warps' sums are added in warp order
//   in shared memory that aliases the ring, and the block writes one
//   (26, 32) slice of the (parts, 26, C) partials.  dw5x5_dw_reduce adds
//   the parts in order: two launches, no atomics, bitwise repeatable.
// What holds the ring back (PERF.md, section 6): not the loads, which the ring
// hides (a build that skips the copies runs as fast), but the stencil's
// own instruction issue and latency at 32 warps per SM.
//
// The sliding-row kernel, dw5x5_bf16 (bf16 #2, #3 and #4): the row ring's
// bf16 instances widened every element into the fp32 ring and then ran the
// fp32 stencil, 48 shared loads for 200 FMAs an item, about one item a warp
// between two block barriers; they ran at 22-29% of their HBM bound, no
// faster than fp32.  Here:
// - A warp is one 32-channel chunk's column strip of kStrip = 4 outputs,
//   a lane a channel; a block is the S = ceil(W / 4) strips of K chunks
//   (K a power of two: the geometry picks 2-4 warps a block where rows are
//   short, a warp a strip where they are long) and the batch rows of one
//   part, streamed as slots, H + 4 an image, the two halo slots above and
//   below never copied nor computed.
// - A pass is G = 5 slots (the register rotation below).  Rows land by
//   cp.async in bf16 staging rows P passes ahead; the thread that copied
//   an element widens it, through swish (ex2 and rcp with denormals
//   flushed), into an fp32 ring of the last two passes (dW/db: and the two
//   slots before them), rows of W + 4 pixels with zero pads; one
//   __syncthreads a pass.  No integer division in the loop: each stream
//   position is carried from pass to pass.
// - The forward keeps, per lane, 5 x 4 fp32 accumulators: the output rows
//   in flight.  A real input row is read once per warp (8 shared loads) and
//   its 100 FMAs go to the 5 rows it feeds, tap row dy to the row that
//   started dy slots ago, so every output takes its taps in dy-major,
//   dx-minor order; a row is stored (bias last, rounded once) at the slot
//   that brings its fifth tap row, through a warp tile as 16-byte stores
//   (scalar stores where C % 8 != 0).  Which register holds which row
//   turns with the slot index mod 5, fixed by unrolling 5 slots: no moves.
// - dx is the forward's stencil over dy (widened as it is, no swish) with
//   the taps flipped in registers.  Its swish'(x) epilogue reads x at the
//   output position: slot q, which completes output row s - 4, stages bf16
//   x of that image row beside its own dy row (the dy row of slot q - 2),
//   in (P + 1) G rows as dW/db stages g, so the row is read in its own
//   pass.  At the store each lane widens its 4 x values, takes swish'
//   (ex2 and rcp with denormals flushed) in fp32 in registers, multiplies
//   and rounds once, writing the result over the x values it read: that
//   slice of the staging row is the warp's 16-byte store tile, so dx
//   needs no tiles of its own (at 32x32 that keeps 3 blocks an SM).
//   Widening x into an fp32 aux ring as swish'(x) by its copier, the
//   ring's way, would cost the same MUFU work (once per element either
//   way) and more shared bytes (16x16x384: 58,368 B a block against
//   40,960, 3 blocks an SM against 5); so x stays bf16 until the store.
//   The nox form copies no x (its rows stay reserved: the geometry is the
//   shape's alone).
// - dW/db keeps the 25 tap sums and db per lane and the g rows of the last
//   5 slots (read as bf16 from their staging rows, widened in registers);
//   the x row of slot q - 2 meets the g rows of slots q - 4 .. q.  The
//   strips' sums are added in strip order, then the parts by
//   dw5x5_dw_reduce: still two launches, no atomics.
// What holds it back (chip_ring_probe.py --bf16, PERF.md section 6, on an
// NVIDIA H100 80GB HBM3 at 700 W): the stencil's issue again, now at 1.5
// instructions an FMA, with the widening (MUFU) and the copies' latency
// partly serialised behind it; the small shapes are bound by latency.
// dx adds its epilogue (about 10 instructions an output: a shared load,
// ex2, rcp and the swish' arithmetic; with the stores 13-17% of its time)
// and a second stream of copies (with dy's, 12-14%).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTaps = 5;
constexpr int kTaps2 = kTaps * kTaps;
constexpr int kSums = kTaps2 + 1;  // 25 tap sums and the bias sum
constexpr int kPad = 2;
constexpr int kHalo = 2 * kPad;  // zero slots per image, and zero columns
constexpr int kChunk = 32;       // channels per block, one per lane
constexpr int kRun = 4;          // adjacent outputs along W per item
constexpr int kRows = 2;         // adjacent output rows per item
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * kChunk;
constexpr int kMinBlocks = 4;    // per SM: at most 64 registers a thread
constexpr int kMaxAhead = 8;     // passes in flight, at most
constexpr long long kMaxSmem = 232448;

enum Kind { kFwd = 0, kDx = 1, kDw = 2 };

struct Args {
  const void* src;  // the streamed rows: x (forward, dW/db) or dy (dx)
  const void* aux;  // per output row: g (dW/db) or x (dx's swish'), or null
  const void* w;    // taps (forward, dx), fp32 or bf16 as the operands
  const float* bias;
  void* out;         // y, dx, or the (parts, 26, C) partials
  long long sdy, sdx, sc;
  int batch, H, W, C;
  int parts;     // blocks per channel chunk
  int per_pass;  // slots filled per pass (G)
  int ahead;     // passes in flight ahead of the one computed (P)
  int vec;       // 16-byte copies
  int vec_out;   // bf16 forward: 16-byte stores of y
};

// __expf and __fdividef: a few ulp from expf and IEEE division, far inside
// the kernels' limits (atol 2e-5), at a quarter of the instructions.
__device__ __forceinline__ float sigmoid(float v) {
  return __fdividef(1.0f, 1.0f + __expf(-v));
}

__device__ __forceinline__ float swish(float v) { return v * sigmoid(v); }

__device__ __forceinline__ float swish_grad(float v) {
  const float s = sigmoid(v);
  return s * (1.0f + v * (1.0f - s));
}

// The sliding kernel's sigmoid: the same two approximations with
// denormals flushed to zero (ex2.approx.ftz, rcp.approx.ftz), which saves
// their range fix-ups; only a denormal sigmoid, at x < -87, differs, by
// less than 2^-126.
__device__ __forceinline__ float sigmoid_ftz(float v) {
  float e, r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(v * -1.4426950408889634f));
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(1.0f + e));
  return r;
}

__device__ __forceinline__ float swish_ftz(float v) {
  return v * sigmoid_ftz(v);
}

__device__ __forceinline__ float swish_grad_ftz(float v) {
  const float s = sigmoid_ftz(v);
  return s * (1.0f + v * (1.0f - s));
}

enum Op { kIdentity = 0, kSwishFtzOp = 1 };

template <int kOp>
__device__ __forceinline__ float apply_op(float v) {
  return kOp == kSwishFtzOp ? swish_ftz(v) : v;
}

// bf16: one copy's staged elements at `sp` (8 for a 16-byte copy, else 2)
// widened through kOp into the fp32 row at `dst`.
template <int kOp>
__device__ __forceinline__ void widen_copy(const __nv_bfloat16* sp,
                                           float* dst, bool vec) {
  if (vec) {
    const uint4 raw = *reinterpret_cast<const uint4*>(sp);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
    float v[8];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      v[2 * j] = apply_op<kOp>(f.x);
      v[2 * j + 1] = apply_op<kOp>(f.y);
    }
    float4* p = reinterpret_cast<float4*>(dst);
    p[0] = make_float4(v[0], v[1], v[2], v[3]);
    p[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sp));
    *reinterpret_cast<float2*>(dst) =
        make_float2(apply_op<kOp>(f.x), apply_op<kOp>(f.y));
  }
}

// Copy 16 (vec) or 4 bytes global -> shared; zero-fill when !valid.
__device__ __forceinline__ void copy_async(void* dst, const void* src,
                                           bool valid, bool vec) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (vec) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(valid ? 16 : 0)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(valid ? 4 : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void commit_group() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// wait_group takes an immediate: at most n of this thread's groups pending.
__device__ __forceinline__ void wait_pending(int n) {
  switch (n) {
    case 7: wait_group<7>(); break;
    case 6: wait_group<6>(); break;
    case 5: wait_group<5>(); break;
    case 4: wait_group<4>(); break;
    case 3: wait_group<3>(); break;
    case 2: wait_group<2>(); break;
    case 1: wait_group<1>(); break;
    default: wait_group<0>(); break;
  }
}

// Where slots live.  A cursor is the first slot q of a pass: its image (in
// the block's list), its slot within the image (0 .. H + 3), its ring row
// and its aux ring row.  Moving on by a pass and finding slot q + gi take
// no division.
struct Slot {
  int img, s, ring, aux;
};

struct Cursor {
  int q, img, s, ring, aux;
};

struct Stream {
  int hs, ring_rows, aux_rows, G;

  __device__ __forceinline__ Cursor at(int q) const {
    return Cursor{q, q / hs, q % hs, q % ring_rows, q % aux_rows};
  }
  __device__ __forceinline__ void next(Cursor& c) const {
    c.q += G;
    c.s += G;
    while (c.s >= hs) {
      c.s -= hs;
      ++c.img;
    }
    c.ring += G;
    if (c.ring >= ring_rows) c.ring -= ring_rows;
    c.aux += G;
    if (c.aux >= aux_rows) c.aux -= aux_rows;
  }
  // Slot q + gi, 0 <= gi < G (G < aux_rows < ring_rows).
  __device__ __forceinline__ Slot slot(const Cursor& c, int gi) const {
    Slot t{c.img, c.s + gi, c.ring + gi, c.aux + gi};
    while (t.s >= hs) {
      t.s -= hs;
      ++t.img;
    }
    if (t.ring >= ring_rows) t.ring -= ring_rows;
    if (t.aux >= aux_rows) t.aux -= aux_rows;
    return t;
  }
};

// The shared core of the fp32 kernels; see the header.  kSwish: swish on
// the ring's rows (forward, dW/db).  kAuxOp: dx's swish' epilogue.
template <int kKind, bool kSwish, bool kBias, bool kAuxOp>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
dw5x5_ring(const Args a) {
  constexpr bool kAux = kKind == kDw || kAuxOp;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int lane = tid & (kChunk - 1);
  const int warp = tid / kChunk;
  const int chunk = blockIdx.x / a.parts;
  const int part = blockIdx.x - chunk * a.parts;
  const int H = a.H, W = a.W, C = a.C, G = a.per_pass;
  const int c0 = chunk * kChunk;
  const int c = c0 + lane;
  const bool live = c < C;
  const int first = (int)((long long)part * a.batch / a.parts);
  const int last = (int)((long long)(part + 1) * a.batch / a.parts);
  const int n_slots = (last - first) * (H + kHalo);
  const int n_pass = (n_slots + G - 1) / G;
  const Stream st{H + kHalo, (a.ahead + 1) * G + kHalo, (a.ahead + 1) * G, G};
  // Rows are padded to whole runs of kRun outputs, so an item's loads need
  // no bounds; the pad columns stay zero.
  const int runs = (W + kRun - 1) / kRun;
  const int row_f = (runs * kRun + kHalo) * kChunk;  // floats per ring row
  const int aux_f = runs * kRun * kChunk;
  float* ring = smem;
  float* aux = smem + (size_t)st.ring_rows * row_f;
  const float* src_t = static_cast<const float*>(a.src);
  const float* aux_t = static_cast<const float*>(a.aux);
  const bool vec = a.vec;

  // Copy mapping: a slot is per_slot copies (pixel, seg elements of the
  // chunk).  With per_slot <= 256 a thread owns one copy column and the
  // slots g0, g0 + gstep, ... of each pass; wider rows give each thread the
  // columns tid, tid + 256, ... of every slot.
  const int seg = vec ? 4 : 1;
  const int px_shift = vec ? 3 : 5;  // copies per pixel: 8 or 32
  const int per_slot = W << px_shift;
  int g0 = 0, gstep = 1, col0 = tid, colstep = kThreads;
  if (per_slot <= kThreads) {
    gstep = kThreads / per_slot;
    g0 = tid / per_slot;
    col0 = tid - g0 * per_slot;
    colstep = per_slot;
    if (g0 >= gstep) g0 = G;  // a leftover thread: no copies
  }

  // The whole ring starts at zero: the halo columns and the pad stay so,
  // and rows not yet filled hold finite values.
  const int n_zero =
      st.ring_rows * row_f + (kKind != kFwd ? st.aux_rows * aux_f : 0);
  for (int e = tid; e < n_zero; e += kThreads) {
    smem[e] = 0.0f;
  }
  __syncthreads();  // before any copy lands on these words

  float tap[kTaps2];
  float sum[kSums];
#pragma unroll
  for (int t = 0; t < kTaps2; ++t) {
    // Flipping both tap axes maps tap dy * 5 + dx to 24 - (dy * 5 + dx).
    const int u = kKind == kDx ? kTaps2 - 1 - t : t;
    tap[t] = kKind != kDw && live
                 ? static_cast<const float*>(a.w)[(u / kTaps) * a.sdy +
                                                  (u % kTaps) * a.sdx +
                                                  (long long)c * a.sc]
                 : 0.0f;
  }
#pragma unroll
  for (int t = 0; t < kSums; ++t) sum[t] = 0.0f;
  const float b = kBias && live ? a.bias[c] : 0.0f;

  // Start the copies of the pass at `cur`: ring row ih = s - 2 of each slot
  // (zero-filled outside the image), and for dx / dW/db the aux row s - 4
  // of each slot that ends an output row.
  auto issue = [&](const Cursor& cur) {
    for (int gi = g0; gi < G && cur.q + gi < n_slots; gi += gstep) {
      const Slot t = st.slot(cur, gi);
      const int ih = t.s - kPad;
      const bool row_in = ih >= 0 && ih < H;
      const size_t img_row = (size_t)(first + t.img) * H;
      const float* src = row_in ? src_t + (img_row + ih) * W * C + c0 : src_t;
      float* dst = ring + (size_t)t.ring * row_f + kPad * kChunk;
      const bool has_aux = kAux && t.s >= kHalo;
      const float* asrc =
          has_aux ? aux_t + (img_row + t.s - kHalo) * W * C + c0 : aux_t;
      float* adst = aux + (size_t)t.aux * aux_f;
      for (int col = col0; col < per_slot; col += colstep) {
        const int px = col >> px_shift;
        const int cl = (col - (px << px_shift)) * seg;
        const bool in_c = c0 + cl < C;
        const size_t off = (size_t)px * C + cl;
        copy_async(dst + px * kChunk + cl, row_in && in_c ? src + off : src_t,
                   row_in && in_c, vec);
        if (has_aux) {
          copy_async(adst + px * kChunk + cl, in_c ? asrc + off : aux_t, in_c,
                     vec);
        }
      }
    }
    commit_group();
  };
  // Swish on this thread's landed ring elements of the pass at `cur`, and
  // swish' on its aux elements (dx).
  auto transform = [&](const Cursor& cur) {
    if (!(kSwish || kAuxOp)) return;
    for (int gi = g0; gi < G && cur.q + gi < n_slots; gi += gstep) {
      const Slot t = st.slot(cur, gi);
      const bool row_in = t.s >= kPad && t.s < H + kPad;
      const bool has_aux = kAuxOp && t.s >= kHalo;
      float* dst = ring + (size_t)t.ring * row_f + kPad * kChunk;
      float* adst = aux + (size_t)t.aux * aux_f;
      for (int col = col0; col < per_slot; col += colstep) {
        const int px = col >> px_shift;
        const int at = px * kChunk + (col - (px << px_shift)) * seg;
        if (kSwish && row_in) {
          if (vec) {
            float4* p = reinterpret_cast<float4*>(dst + at);
            float4 v = *p;
            v.x = swish(v.x);
            v.y = swish(v.y);
            v.z = swish(v.z);
            v.w = swish(v.w);
            *p = v;
          } else {
            dst[at] = swish(dst[at]);
          }
        }
        if (has_aux) {
          if (vec) {
            float4* p = reinterpret_cast<float4*>(adst + at);
            float4 v = *p;
            v.x = swish_grad(v.x);
            v.y = swish_grad(v.y);
            v.z = swish_grad(v.z);
            v.w = swish_grad(v.w);
            *p = v;
          } else {
            adst[at] = swish_grad(adst[at]);
          }
        }
      }
    }
  };

  // Compute mapping: an item is (kRows slots gi .. gi + kRows - 1 with gi a
  // multiple of kRows, run of kRun columns); warp w takes items w, w + 8,
  // ... of a pass, the same for every pass.  An item reads ring slots
  // gi - 4 .. gi + kRows - 1 (kRows + 4 rows of kRun + 4 values) and
  // computes the output rows that end at those slots.  A slot that is a
  // halo row, or lies in the next image (then it is one of its top halo
  // rows), or past the stream, ends no output row: its row is not stored,
  // and dW/db weighs it by g = 0.  So the stored rows are consecutive rows
  // of one image.
  const int groups = G / kRows;
  const int gr_first = warp / runs;
  const int run_first = warp - gr_first * runs;
  const int gr_step = kWarps / runs;
  const int run_step = kWarps - gr_step * runs;
  auto compute = [&](const Cursor& cur) {
    if (!live) return;
    int run = run_first;
    for (int gr = gr_first; gr < groups && cur.q + gr * kRows < n_slots;) {
      const int gi = gr * kRows;
      const Slot t = st.slot(cur, gi);
      const int w0 = run * kRun;
      run += run_step;
      gr += gr_step;
      if (run >= runs) {
        run -= runs;
        ++gr;
      }
      bool out[kRows];
      bool any = false;
#pragma unroll
      for (int o = 0; o < kRows; ++o) {
        out[o] = t.s + o >= kHalo && t.s + o < st.hs &&
                 cur.q + gi + o < n_slots;
        any = any || out[o];
      }
      if (!any) continue;
      const int n_out = min(kRun, W - w0);
      float acc[kRows][kRun];
      float gv[kRows][kRun];
      // Row o's aux row: g (dW/db) or swish'(x) (dx) at its outputs.
      auto aux_at = [&](int o) {
        int ar = t.aux + o;
        if (ar >= st.aux_rows) ar -= st.aux_rows;
        return aux + (size_t)ar * aux_f + w0 * kChunk + lane;
      };
#pragma unroll
      for (int o = 0; o < kRows; ++o) {
        const float* at = aux_at(o);
#pragma unroll
        for (int i = 0; i < kRun; ++i) {
          acc[o][i] = 0.0f;
          gv[o][i] = kKind == kDw && out[o] ? at[i * kChunk] : 0.0f;
          if (kKind == kDw) sum[kTaps2] += gv[o][i];
        }
      }
      int rr = t.ring - kHalo;  // slot gi - 4: tap row 0 of output row 0
      if (rr < 0) rr += st.ring_rows;
#pragma unroll
      for (int jr = 0; jr < kRows + kTaps - 1; ++jr) {
        const float* row = ring + (size_t)rr * row_f + w0 * kChunk + lane;
        float v[kRun + kTaps - 1];
#pragma unroll
        for (int j = 0; j < kRun + kTaps - 1; ++j) v[j] = row[j * kChunk];
        // dx outermost: consecutive FMAs go to different sums (each sum
        // still takes its taps in dx order).
#pragma unroll
        for (int dx = 0; dx < kTaps; ++dx) {
#pragma unroll
          for (int o = 0; o < kRows; ++o) {
            const int dy = jr - o;
            if (dy < 0 || dy >= kTaps) continue;
#pragma unroll
            for (int i = 0; i < kRun; ++i) {
              if (kKind == kDw) {
                sum[dy * kTaps + dx] =
                    fmaf(v[i + dx], gv[o][i], sum[dy * kTaps + dx]);
              } else {
                acc[o][i] = fmaf(v[i + dx], tap[dy * kTaps + dx], acc[o][i]);
              }
            }
          }
        }
        if (++rr == st.ring_rows) rr = 0;
      }
      if (kKind != kDw) {
        // Row o of the item is image row t.s - 4 + o (negative only for
        // rows that are not stored).
        const long long row0 = (long long)(first + t.img) * H + t.s - kHalo;
#pragma unroll
        for (int o = 0; o < kRows; ++o) {
          if (!out[o]) continue;
          float* dst =
              static_cast<float*>(a.out) + ((row0 + o) * W + w0) * C + c;
          const float* at = aux_at(o);
#pragma unroll
          for (int i = 0; i < kRun; ++i) {
            if (i < n_out) {
              float r = kBias ? acc[o][i] + b : acc[o][i];
              if (kAuxOp) r *= at[i * kChunk];
              dst[i * C] = r;
            }
          }
        }
      }
    }
  };

  Cursor fill = st.at(0);
  for (int p = 0; p < a.ahead; ++p) {
    issue(fill);
    st.next(fill);
  }
  Cursor cur = st.at(0);
  for (int p = 0; p < n_pass; ++p) {
    wait_pending(a.ahead - 1);  // this thread's copies of pass p landed
    transform(cur);
    __syncthreads();  // pass p visible to all; pass p - 1 read by all
    issue(fill);  // pass p + P, into the rows pass p - 1 read
    st.next(fill);
    compute(cur);
    st.next(cur);
  }
  wait_group<0>();

  if (kKind == kDw) {
    // The warps' sums, added in warp order, in shared memory that aliases
    // the ring (every read of it is behind this barrier).
    __syncthreads();
    float* red = smem;
#pragma unroll
    for (int t = 0; t < kSums; ++t) {
      red[(warp * kSums + t) * kChunk + lane] = sum[t];
    }
    __syncthreads();
    for (int e = tid; e < kSums * kChunk; e += kThreads) {
      const int t = e / kChunk;
      const int ln = e - t * kChunk;
      float s = 0.0f;
      for (int wp = 0; wp < kWarps; ++wp) s += red[(wp * kSums + t) * kChunk + ln];
      if (c0 + ln < C) {
        static_cast<float*>(a.out)[((size_t)part * kSums + t) * C + c0 + ln] = s;
      }
    }
  }
}

// ---- bf16 #2, #3 and #4: the sliding-row kernel ----------------------------
//
// The bf16 forward, dx and dW/db (see the header).  One block is a group of K
// channel chunks (K x 32 channels) and the batch rows of one part; warp w is
// chunk w / S of the group and column strip w % S, the kStrip output columns
// [4 (w % S), 4 (w % S) + 4) of every row (S = ceil(W / 4) strips), one
// channel per lane.  The block streams its images as slots, H + 4 per image
// (two zero slots above, two below, never copied or computed), G slots a
// pass, P passes of copies in flight.
constexpr int kStrip = 4;       // output columns per lane
constexpr int kMaxThreadsBf16 = 1024;

// Registers a thread may use per build, through __launch_bounds__: the
// forward's 256-thread build 3 blocks an SM (at most 80), dx's and dW/db's
// 2 (128: at 80, dx spills, and ran 2-12% slower at the path shapes in
// chip_ring_probe.py's dx_two_blocks; dW/db's rings allow no more), 512
// threads 1 (128), 1024 threads 1 (64).  depthwise.py's geometry() assumes
// the same.
constexpr int bf16_min_blocks(int kind, int threads) {
  return threads != 256 ? 1 : kind == kFwd ? 3 : 2;
}

// kSwish: swish on the streamed x (forward, dW/db), or dx's swish'(x)
// epilogue (dx, whose dy rows are widened as they are).
template <int kKind, bool kSwish, bool kBias, int kMaxThreads>
__global__ void __launch_bounds__(kMaxThreads,
                                  bf16_min_blocks(kKind, kMaxThreads))
dw5x5_bf16(const Args a) {
  using B16 = __nv_bfloat16;
  constexpr bool kDwK = kKind == kDw;
  constexpr bool kDxK = kKind == kDx;
  constexpr bool kFwdK = kKind == kFwd;
  constexpr bool kGrad = kDxK && kSwish;  // x staged for swish'(x)
  extern __shared__ __align__(16) float smem[];
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & (kChunk - 1);
  const int warp = tid / kChunk;
  const int H = a.H, W = a.W, C = a.C, G = a.per_pass, P = a.ahead;
  const int S = (W + kStrip - 1) / kStrip;
  const int K = T / (kChunk * S);
  const int KC = K * kChunk;
  const int group = blockIdx.x / a.parts;
  const int part = blockIdx.x - group * a.parts;
  const int cb = group * KC;
  const int strip = warp % S;
  const int kc = warp / S;
  const int w0 = strip * kStrip;
  const int c = cb + kc * kChunk + lane;
  const bool live = c < C;
  const int first = (int)((long long)part * a.batch / a.parts);
  const int last = (int)((long long)(part + 1) * a.batch / a.parts);
  const int hs = H + kHalo;
  const int n_slots = (last - first) * hs;
  const int n_pass = (n_slots + G - 1) / G;
  // fp32 ring: swish(x) (dx: dy) of the last two passes (and, for dW/db,
  // the two slots before them), per chunk RF rows of S * 4 + 4 pixels x 32
  // fp32, two zero pixels on each side.  bf16 staging, per chunk: x (dx:
  // dy) of P passes (read only by its copier), and for dW/db g, for dx x,
  // of P + 1 passes (read by every warp of the chunk), rows of W pixels x
  // 32.
  const int RF = 2 * G + (kDwK ? kPad : 0);
  const int RX = P * G;
  const int RG = (P + 1) * G;
  const int PW = S * kStrip + kHalo;
  const int row_f = PW * kChunk;  // floats per ring row of one chunk
  const int row_h = W * kChunk;   // bf16 per staging row of one chunk
  int ring_f = K * RF * row_f;
  if (kDwK && ring_f < S * K * kSums * kChunk) ring_f = S * K * kSums * kChunk;
  float* ring = smem;
  B16* xst = reinterpret_cast<B16*>(smem + ring_f);
  B16* gst = xst + (size_t)K * RX * row_h;
  // Forward: each warp's two 4 x 32 bf16 tiles of finished outputs, read
  // back across the lanes for 16-byte stores (dx: the warp's own slice of
  // the x staging row it has just read).
  B16* tiles = gst + (size_t)warp * 2 * kStrip * kChunk;
  const B16* src = static_cast<const B16*>(a.src);
  const B16* aux = static_cast<const B16*>(a.aux);
  const bool vec = a.vec;

  // Copy mapping, the same every pass: per slot W pixels of pseg copies
  // (8 channels, or 2 where the copies are 4 bytes); a thread owns copy
  // column col0 (+ colstep ...) of slots g0, g0 + gstep, ... of a pass, and
  // widens what it copied.
  const int seg = vec ? 8 : 2;
  const int pseg = KC / seg;
  const int pshift = __ffs(pseg) - 1;
  const int per_slot = W << pshift;
  int g0 = 0, gstep = 1, col0 = tid, colstep = T;
  if (per_slot <= T) {
    gstep = T / per_slot;
    g0 = tid / per_slot;
    col0 = tid - g0 * per_slot;
    colstep = per_slot;
    if (g0 >= gstep) g0 = G;  // a leftover thread: no copies
  }
  // Where a pass's first slot lives, carried from pass to pass: its image
  // and slot in it, its x and g staging rows, its fp32 ring row.
  struct Pass {
    int q, img, s, xr, gr, fr;
  };
  auto next = [&](Pass& u) {
    u.q += G;
    u.s += G;
    while (u.s >= hs) {
      u.s -= hs;
      ++u.img;
    }
    u.xr += G;
    if (u.xr == RX) u.xr = 0;
    u.gr += G;
    if (u.gr == RG) u.gr = 0;
    u.fr += G;
    if (u.fr >= RF) u.fr -= RF;
  };

  // Start the copies of the pass at `u`: the real rows of its slots (bf16
  // x or dy, and g beside them for dW/db), and for dx's swish' the x row of
  // each slot that completes an output row (image row s - 4, the row of
  // slot q - 2); channels past C zero-filled.
  const int row_y = W * C;  // elements an image row (< 2^31)
  auto issue = [&](const Pass& u) {
    int s = u.s + g0, img = u.img;
    for (int gi = g0; gi < G && u.q + gi < n_slots; gi += gstep) {
      while (s >= hs) {
        s -= hs;
        ++img;
      }
      const int ih = s - kPad;
      const bool row_in = ih >= 0 && ih < H;
      const bool x_in = kGrad && s >= kHalo;
      if (row_in || x_in) {
        // Image row ih, or for x (ih >= 2 there) row ih - 2: not negative.
        const size_t grow =
            ((size_t)(first + img) * H + ih) * (size_t)row_y + cb;
        B16* xd = xst + (u.xr + gi) * row_h;
        B16* gd = gst + (u.gr + gi) * row_h;
        for (int col = col0; col < per_slot; col += colstep) {
          const int px = col >> pshift;
          const int ch = (col & (pseg - 1)) * seg;
          const int k = ch / kChunk;
          const int at = (k * RX * W + px) * kChunk + ch - k * kChunk;
          const bool in_c = cb + ch < C;
          const size_t off = grow + (size_t)px * C + ch;
          if (row_in) copy_async(xd + at, in_c ? src + off : src, in_c, vec);
          if (kDwK || x_in) {
            const size_t aoff = kDwK ? off : off - 2 * (size_t)row_y;
            copy_async(gd + at + k * (RG - RX) * row_h,
                       in_c ? aux + aoff : aux, in_c, vec);
          }
        }
      }
      s += gstep;
    }
    commit_group();
  };
  // This thread's staged x of the pass at `u`, widened (and through swish;
  // dx's dy as it is) into the fp32 ring: once per element.
  constexpr int kOp = kSwish && !kDxK ? kSwishFtzOp : kIdentity;
  auto transform = [&](const Pass& u) {
    int s = u.s + g0;
    for (int gi = g0; gi < G && u.q + gi < n_slots; gi += gstep) {
      while (s >= hs) s -= hs;
      if (s >= kPad && s < H + kPad) {
        int fr = u.fr + gi;
        if (fr >= RF) fr -= RF;
        const B16* xs = xst + (u.xr + gi) * row_h;
        float* dst = ring + (fr * PW + kPad) * kChunk;
        for (int col = col0; col < per_slot; col += colstep) {
          const int px = col >> pshift;
          const int ch = (col & (pseg - 1)) * seg;
          const int k = ch / kChunk;
          const int cl = ch - k * kChunk;
          widen_copy<kOp>(xs + (k * RX * W + px) * kChunk + cl,
                          dst + (k * RF * PW + px) * kChunk + cl, vec);
        }
      }
      s += gstep;
    }
  };

  Pass fill{0, 0, 0, 0, 0, 0};
  for (int p = 0; p < P; ++p) {
    issue(fill);
    next(fill);
  }
  // The fp32 ring starts at zero: its pad columns stay so.
  for (int e = tid * 4; e < K * RF * row_f; e += T * 4) {
    *reinterpret_cast<float4*>(ring + e) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float tap[kTaps2];
#pragma unroll
  for (int t = 0; t < kTaps2; ++t) {
    // dx: both tap axes flipped, tap dy * 5 + dx from 24 - (dy * 5 + dx).
    const int u = kDxK ? kTaps2 - 1 - t : t;
    tap[t] = !kDwK && live
                 ? __bfloat162float(static_cast<const B16*>(a.w)[
                       (u / kTaps) * a.sdy + (u % kTaps) * a.sdx +
                       (long long)c * a.sc])
                 : 0.0f;
  }
  const float b = kBias && live ? a.bias[c] : 0.0f;
  __syncthreads();  // the zeros, before any widened row lands

  // The lane's view of ring row r: padded pixel w0 + u (image column
  // w0 + u - 2), u = 0 .. 7, at xlane[r * row_f + u * 32]; of g (dx: x)
  // staging row r: column w0 + i at glane[r * row_h + i * 32].
  const float* xlane = ring + (kc * RF * PW + w0) * kChunk + lane;
  B16* glane = gst + (kc * RG * W + w0) * kChunk + lane;
  const int n_col = min(kStrip, W - w0);  // the strip's columns in the image
  // Forward: acc[(q - dy) % 5] gathers tap row dy of the output row that
  // started at slot q - dy; it is stored (with the bias) and cleared at
  // the slot that completes it, four after its start.  dW/db: gw[q % 5]
  // holds g of slot q (zero for the halo slots), and the x row of slot
  // q - 2 meets the g rows of slots q - 4 .. q.  Both in fp32, taps in
  // dy-major, dx-minor order.  Tap rows that fall outside the image go to
  // rows that are never stored (forward) or meet g = 0 (dW/db).  The
  // index q % 5 is static: a pass is a multiple of 5 slots.
  float acc[kTaps][kStrip];
  float gw[kTaps][kStrip];
  float sum[kSums];
#pragma unroll
  for (int d = 0; d < kTaps; ++d) {
#pragma unroll
    for (int i = 0; i < kStrip; ++i) {
      acc[d][i] = 0.0f;
      gw[d][i] = 0.0f;
    }
  }
#pragma unroll
  for (int t = 0; t < kSums; ++t) sum[t] = 0.0f;
  B16* y = static_cast<B16*>(a.out);
  // A finished row's stores: lane `lane` writes channel c of the strip's
  // columns, or (16-byte stores) lanes 0 .. 15 write channels
  // 8 (lane % 4) .. + 7 of column w0 + lane / 4.
  const bool vec_out = a.vec_out;
  const int out_ch = cb + kc * kChunk + (lane % 4) * 8;
  const bool out_live = vec_out ? lane < 4 * n_col && out_ch < C : live;
  // y at output row s - 4 of the slot's image (before the image where
  // s < 4), this lane's first element; tile: the one the next row uses.
  B16* yp = y + (vec_out ? (long long)(lane / 4) * C + out_ch : c) +
            ((long long)first * H - kHalo) * row_y + w0 * (long long)C;
  int tile = 0;
  // The compute cursor: slot in the image, ring row (forward, dx: slot q;
  // dW/db: slot q - 2), g (dx: x) staging row of slot q.
  int s = 0;
  int rr = kDwK ? RF - kPad : 0;
  int rg = 0;

  auto compute = [&](int q0) {
    const int n = min(G, n_slots - q0);
    for (int gi = 0; gi < n; gi += kTaps) {
#pragma unroll
      for (int j = 0; j < kTaps; ++j) {
        if (gi + j < n) {
          if (!kDwK) {
            if (s >= kPad && s < H + kPad) {
              const float* row = xlane + rr * row_f;
              float v[kStrip + kTaps - 1];
#pragma unroll
              for (int u = 0; u < kStrip + kTaps - 1; ++u) {
                v[u] = row[u * kChunk];
              }
#pragma unroll
              for (int dy = 0; dy < kTaps; ++dy) {
#pragma unroll
                for (int dx = 0; dx < kTaps; ++dx) {
#pragma unroll
                  for (int i = 0; i < kStrip; ++i) {
                    acc[(j - dy + kTaps) % kTaps][i] =
                        fmaf(v[i + dx], tap[dy * kTaps + dx],
                             acc[(j - dy + kTaps) % kTaps][i]);
                  }
                }
              }
            }
            const int kDone = (j + 1) % kTaps;  // started 4 slots ago
            if (s >= kHalo) {  // output row s - 4 is complete
              // Its outputs: the bias last (forward), or times swish'(x) of
              // this slot's staged x row (dx), rounded once.  dx's tile is
              // the warp's slice of that x row (4 pixels x 32, the tile's
              // layout): each lane overwrites only the x values it has
              // read, and no other warp reads the slice.
              B16* t = kDxK ? glane - lane + rg * row_h
                            : tiles + tile * kStrip * kChunk;
              if (!kDxK) tile ^= 1;
              if (kGrad) {  // all four x values first, then their swish'
                float xv[kStrip];
#pragma unroll
                for (int i = 0; i < kStrip; ++i) {
                  xv[i] = i < n_col ? __bfloat162float(t[i * kChunk + lane])
                                    : 0.0f;
                }
#pragma unroll
                for (int i = 0; i < kStrip; ++i) {
                  acc[kDone][i] *= swish_grad_ftz(xv[i]);
                }
              }
#pragma unroll
              for (int i = 0; i < kStrip; ++i) {
                if (kBias) acc[kDone][i] += b;
              }
              if (vec_out) {
#pragma unroll
                for (int i = 0; i < kStrip; ++i) {
                  // dx: columns past W are the next row's pixels.
                  if (!kDxK || i < n_col) {
                    t[i * kChunk + lane] = __float2bfloat16_rn(acc[kDone][i]);
                  }
                }
                __syncwarp();
                if (out_live) {
                  *reinterpret_cast<uint4*>(yp) =
                      *reinterpret_cast<const uint4*>(t + lane * 8);
                }
              } else if (live) {
#pragma unroll
                for (int i = 0; i < kStrip; ++i) {
                  if (i < n_col) yp[i * C] = __float2bfloat16_rn(acc[kDone][i]);
                }
              }
            }
#pragma unroll
            for (int i = 0; i < kStrip; ++i) acc[kDone][i] = 0.0f;
          } else {
#pragma unroll
            for (int i = 0; i < kStrip; ++i) gw[j][i] = 0.0f;
            if (s >= kPad && s < H + kPad) {
              const B16* grow = glane + rg * row_h;
#pragma unroll
              for (int i = 0; i < kStrip; ++i) {
                if (i < n_col) gw[j][i] = __bfloat162float(grow[i * kChunk]);
              }
#pragma unroll
              for (int i = 0; i < kStrip; ++i) sum[kTaps2] += gw[j][i];
            }
            if (s >= kHalo) {  // the x row of slot q - 2 is image row s - 4
              const float* row = xlane + rr * row_f;
              float v[kStrip + kTaps - 1];
#pragma unroll
              for (int u = 0; u < kStrip + kTaps - 1; ++u) {
                v[u] = row[u * kChunk];
              }
#pragma unroll
              for (int dy = 0; dy < kTaps; ++dy) {
                // Output row s - 2 - dy, whose g is in slot q - dy.
#pragma unroll
                for (int dx = 0; dx < kTaps; ++dx) {
#pragma unroll
                  for (int i = 0; i < kStrip; ++i) {
                    sum[dy * kTaps + dx] =
                        fmaf(v[i + dx], gw[(j - dy + kTaps) % kTaps][i],
                             sum[dy * kTaps + dx]);
                  }
                }
              }
            }
          }
          if (!kFwdK && ++rg == RG) rg = 0;
          if (++rr == RF) rr = 0;
          yp += row_y;
          if (++s == hs) {
            s = 0;
            yp -= kHalo * row_y;  // the next image's output row -4
          }
        }
      }
    }
  };

  Pass cur{0, 0, 0, 0, 0, 0};
  for (int p = 0; p < n_pass; ++p) {
    wait_pending(P - 1);  // this thread's copies of pass p landed
    transform(cur);
    __syncthreads();  // pass p widened for all; pass p - 1 read by all
    issue(fill);      // pass p + P, into the staging rows pass p left
    next(fill);
    compute(cur.q);
    next(cur);
  }
  wait_group<0>();

  if (kDwK) {
    // The strips' sums of each chunk, added in strip order, in shared
    // memory that aliases the ring (every read of it is behind this
    // barrier).
    __syncthreads();
    float* red = smem;
#pragma unroll
    for (int t = 0; t < kSums; ++t) {
      red[(warp * kSums + t) * kChunk + lane] = sum[t];
    }
    __syncthreads();
    for (int e = tid; e < K * kSums * kChunk; e += T) {
      const int k = e / (kSums * kChunk);
      const int t = (e / kChunk) % kSums;
      const int ln = e % kChunk;
      float acc_s = 0.0f;
      for (int st = 0; st < S; ++st) {
        acc_s += red[((k * S + st) * kSums + t) * kChunk + ln];
      }
      const int ch = cb + k * kChunk + ln;
      if (ch < C) {
        static_cast<float*>(a.out)[((size_t)part * kSums + t) * C + ch] =
            acc_s;
      }
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

// Shared bytes of one row-ring block: the ring and the aux ring (dx,
// dW/db), rows padded to whole runs, for dW/db at least the warps' sums.
// The same formula as geometry() on the host, which the entry points hold
// it to.
long long smem_bytes(int kind, int W, int G, int P) {
  const long long rows = (long long)(P + 1) * G;
  const long long padded = (long long)(W + kRun - 1) / kRun * kRun;
  long long f = (rows + kHalo) * (padded + kHalo) * kChunk;
  if (kind != kFwd) f += rows * padded * kChunk;
  if (kind == kDw && f < kWarps * kSums * kChunk) f = kWarps * kSums * kChunk;
  return 4 * f;
}

// geo: {parts, slots per pass (a multiple of kRows), passes ahead, threads,
// shared bytes}.
bool bad_launch(const int* geo, int kind, int batch, int H, int W, int C) {
  if (batch <= 0 || H <= 0 || W <= 0 || C <= 0 || geo == nullptr) return true;
  const int parts = geo[0], G = geo[1], P = geo[2];
  const long long chunks = (C + kChunk - 1) / kChunk;
  return parts < 1 || parts > batch || G < kRows || G % kRows || P < 1 ||
         P > kMaxAhead || geo[3] != kThreads ||
         (long long)geo[4] != smem_bytes(kind, W, G, P) ||
         geo[4] > kMaxSmem || chunks * parts > 0x7fffffffLL ||
         (long long)batch * (H + kHalo) + G > 0x7fffffffLL;
}

// The bf16 kernels' shared bytes at W, G, P and K chunks a block: the fp32
// ring of 2G (+ 2 for dW/db) rows of (S * 4 + 4) x 32K, for dW/db at least
// the warps' sums, then the bf16 staging rows, P G of x (dx: dy) and, for
// dW/db and dx, (P + 1) G of g or x, W x 32K each, then the forward's
// store tiles.  The same formula as geometry() on the host.
long long smem_bytes_bf16(int kind, int W, int G, int P, int K) {
  const long long S = (W + kStrip - 1) / kStrip;
  const long long kc = (long long)K * kChunk;
  const long long rows = 2LL * G + (kind == kDw ? kPad : 0);
  long long f = rows * (S * kStrip + kHalo) * kc;
  if (kind == kDw && f < S * K * kSums * kChunk) f = S * K * kSums * kChunk;
  const long long staged =
      (long long)P * G + (kind != kFwd ? (long long)(P + 1) * G : 0);
  // The forward's store tiles: two of 4 x 32 bf16 a warp.
  const long long tiles = kind == kFwd ? S * K * 2 * kStrip * kChunk : 0;
  return 4 * f + 2 * (staged * W * kc + tiles);
}

// geo for the bf16 kernels: {parts, slots per pass (a multiple of 5),
// passes ahead, threads = 32 S K (K a power of two), shared bytes}.
bool bad_launch_bf16(const int* geo, int kind, int batch, int H, int W,
                     int C) {
  if (batch <= 0 || H <= 0 || W <= 0 || C <= 0 || geo == nullptr) return true;
  const int parts = geo[0], G = geo[1], P = geo[2], threads = geo[3];
  const int S = (W + kStrip - 1) / kStrip;
  if (threads <= 0 || threads > kMaxThreadsBf16 || threads % (kChunk * S)) {
    return true;
  }
  const int K = threads / (kChunk * S);
  const long long groups = (C + (long long)K * kChunk - 1) / (K * kChunk);
  return (K & (K - 1)) != 0 || parts < 1 || parts > batch || G < kTaps ||
         (long long)W * C > 0x7fffffffLL ||
         G % kTaps || P < 1 || P > kMaxAhead ||
         (long long)geo[4] != smem_bytes_bf16(kind, W, G, P, K) ||
         geo[4] > kMaxSmem || groups * parts > 0x7fffffffLL ||
         (long long)batch * (H + kHalo) + (long long)(P + 2) * G >
             0x7fffffffLL;
}

bool aligned(const void* p, uintptr_t n) {
  return (reinterpret_cast<uintptr_t>(p) & (n - 1)) == 0;
}

bool aligned16(const void* p) { return aligned(p, 16); }

template <int kKind, bool kSwish, bool kBias, bool kAuxOp>
cudaError_t launch(Args a, const int* geo, cudaStream_t stream) {
  a.parts = geo[0];
  a.per_pass = geo[1];
  a.ahead = geo[2];
  // 16-byte copies: 4 fp32 channels.
  a.vec = a.C % 4 == 0 && aligned16(a.src) && aligned16(a.aux) &&
          aligned16(a.out);
  auto kernel = dw5x5_ring<kKind, kSwish, kBias, kAuxOp>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, geo[4]);
  if (err != cudaSuccess) return err;
  const int chunks = (a.C + kChunk - 1) / kChunk;
  kernel<<<chunks * a.parts, kThreads, geo[4], stream>>>(a);
  return cudaGetLastError();
}

template <int kKind, bool kSwish, bool kBias, int kMaxThreads>
cudaError_t launch_bf16_block(const Args& a, const int* geo,
                              cudaStream_t stream) {
  auto kernel = dw5x5_bf16<kKind, kSwish, kBias, kMaxThreads>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, geo[4]);
  if (err != cudaSuccess) return err;
  // All of the SM's 228 KB as shared memory: the geometry counts on it for
  // several blocks an SM.
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const int S = (a.W + kStrip - 1) / kStrip;
  const int kc = geo[3] / S;  // channels a block
  const int groups = (a.C + kc - 1) / kc;
  kernel<<<groups * a.parts, geo[3], geo[4], stream>>>(a);
  return cudaGetLastError();
}

// The bf16 forward, dx or dW/db stage 1, built for the block size geo[3]
// takes.
template <int kKind, bool kSwish, bool kBias>
cudaError_t launch_bf16(Args a, const int* geo, cudaStream_t stream) {
  a.parts = geo[0];
  a.per_pass = geo[1];
  a.ahead = geo[2];
  // 16-byte copies: 8 bf16 channels.
  a.vec = a.C % 8 == 0 && aligned16(a.src) && aligned16(a.aux);
  a.vec_out = a.C % 8 == 0 && aligned16(a.out);
  if (geo[3] <= 256) {
    return launch_bf16_block<kKind, kSwish, kBias, 256>(a, geo, stream);
  }
  if (geo[3] <= 512) {
    return launch_bf16_block<kKind, kSwish, kBias, 512>(a, geo, stream);
  }
  return launch_bf16_block<kKind, kSwish, kBias, 1024>(a, geo, stream);
}

// Stage 2 of dW/db on `stream`: the (n_parts, 26, C) partials into dw and db.
int reduce_parts(void* partial, void* dw, void* db, int C, int n_parts,
                 cudaStream_t stream) {
  const int threads = 256;
  const int blocks = (kSums * C + threads - 1) / threads;
  dw5x5_dw_reduce<<<blocks, threads, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<float*>(dw),
      static_cast<float*>(db), C, n_parts);
  return (int)cudaGetLastError();
}

Args make_args(const void* src, const void* aux, const void* w,
               const void* bias, void* out, int batch, int H, int W, int C,
               long long sdy, long long sdx, long long sc) {
  Args a{};
  a.src = src;
  a.aux = aux;
  a.w = w;
  a.bias = static_cast<const float*>(bias);
  a.out = out;
  a.sdy = sdy;
  a.sdx = sdx;
  a.sc = sc;
  a.batch = batch;
  a.H = H;
  a.W = W;
  a.C = C;
  return a;
}

}  // namespace

// x, y: (batch, H, W, C) contiguous fp32.  w: fp32 taps, element (dy, dx, c)
// at w + dy * sdy + dx * sdx + c * sc.  bias: (C,) fp32 or null.  geo: the
// launch geometry of the forward for this shape (see bad_launch).
// Launches on `stream` of `device` and returns the cudaError_t of the launch.
extern "C" int nvae_dw5x5_fwd(const void* x, const void* w, const void* bias,
                              void* y, int batch, int H, int W, int C,
                              long long sdy, long long sdx, long long sc,
                              int fuse_swish, const int* geo, int device,
                              void* stream) {
  if (bad_launch(geo, kFwd, batch, H, W, C)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Args a = make_args(x, nullptr, w, bias, y, batch, H, W, C, sdy, sdx, sc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fuse_swish) {
    err = bias ? launch<kFwd, true, true, false>(a, geo, s)
               : launch<kFwd, true, false, false>(a, geo, s);
  } else {
    err = bias ? launch<kFwd, false, true, false>(a, geo, s)
               : launch<kFwd, false, false, false>(a, geo, s);
  }
  return (int)err;
}

// The bf16 instance of the forward: x, y (batch, H, W, C) contiguous bf16,
// w bf16 taps with strides as above, bias (C,) fp32 or null; C even, and x
// and y 4-byte aligned (the copies are 16 or 4 bytes: cp.async has no
// 2-byte form).  Sums and bias in fp32, y rounded to bf16 once.
extern "C" int nvae_dw5x5_fwd_bf16(const void* x, const void* w,
                                   const void* bias, void* y, int batch, int H,
                                   int W, int C, long long sdy, long long sdx,
                                   long long sc, int fuse_swish,
                                   const int* geo, int device, void* stream) {
  if (bad_launch_bf16(geo, kFwd, batch, H, W, C) || C % 2 != 0 ||
      !aligned(x, 4) || !aligned(y, 4)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Args a = make_args(x, nullptr, w, bias, y, batch, H, W, C, sdy, sdx, sc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fuse_swish) {
    err = bias ? launch_bf16<kFwd, true, true>(a, geo, s)
               : launch_bf16<kFwd, true, false>(a, geo, s);
  } else {
    err = bias ? launch_bf16<kFwd, false, true>(a, geo, s)
               : launch_bf16<kFwd, false, false>(a, geo, s);
  }
  return (int)err;
}

// dx of the fused op.  dy, dx: (batch, H, W, C) contiguous fp32; w: the
// forward's taps with strides as above; x: the forward's (batch, H, W, C)
// input for the swish' epilogue, or null for the form without swish.
extern "C" int nvae_dw5x5_dx(const void* dy, const void* w, const void* x,
                             void* dx, int batch, int H, int W, int C,
                             long long sdy, long long sdx, long long sc,
                             const int* geo, int device, void* stream) {
  if (bad_launch(geo, kDx, batch, H, W, C)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Args a = make_args(dy, x, w, nullptr, dx, batch, H, W, C, sdy, sdx, sc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = x ? launch<kDx, false, false, true>(a, geo, s)
          : launch<kDx, false, false, false>(a, geo, s);
  return (int)err;
}

// dW/db of the fused op, in two launches.  x, dy: (batch, H, W, C)
// contiguous fp32; partial: (n_parts, 26, C) fp32 scratch, n_parts the
// geometry's parts; dw: (25, C) fp32, tap dy * 5 + dx first; db: (C,) fp32
// or null.
extern "C" int nvae_dw5x5_dw(const void* x, const void* dy, void* partial,
                             void* dw, void* db, int batch, int H, int W,
                             int C, int n_parts, int fuse_swish,
                             const int* geo, int device, void* stream) {
  if (bad_launch(geo, kDw, batch, H, W, C) || n_parts != geo[0]) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Args a = make_args(x, dy, nullptr, nullptr, partial, batch, H, W, C,
                           0, 0, 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = fuse_swish ? launch<kDw, true, false, false>(a, geo, s)
                   : launch<kDw, false, false, false>(a, geo, s);
  if (err != cudaSuccess) return (int)err;
  return reduce_parts(partial, dw, db, C, n_parts, s);
}

// The bf16 instance of dx, on the sliding-row kernel: dy, x, dx (batch, H,
// W, C) contiguous bf16, w bf16 taps with strides as above, x null for the
// form without swish; C even and dy, x and dx 4-byte aligned; geo the bf16
// dx geometry (see bad_launch_bf16).  Sums and swish'(x) in fp32, dx
// rounded to bf16 once.
extern "C" int nvae_dw5x5_dx_bf16(const void* dy, const void* w,
                                  const void* x, void* dx, int batch, int H,
                                  int W, int C, long long sdy, long long sdx,
                                  long long sc, const int* geo, int device,
                                  void* stream) {
  if (bad_launch_bf16(geo, kDx, batch, H, W, C) || C % 2 != 0 ||
      !aligned(dy, 4) || !aligned(x, 4) || !aligned(dx, 4)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Args a = make_args(dy, x, w, nullptr, dx, batch, H, W, C, sdy, sdx, sc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = x ? launch_bf16<kDx, true, false>(a, geo, s)
          : launch_bf16<kDx, false, false>(a, geo, s);
  return (int)err;
}

// The bf16 instance of dW/db: x, dy (batch, H, W, C) contiguous bf16, C
// even, both 4-byte aligned; partial, dw and db fp32 as above.  The sums of
// the widened operands in fp32, the same two launches.
extern "C" int nvae_dw5x5_dw_bf16(const void* x, const void* dy, void* partial,
                                  void* dw, void* db, int batch, int H, int W,
                                  int C, int n_parts, int fuse_swish,
                                  const int* geo, int device, void* stream) {
  if (bad_launch_bf16(geo, kDw, batch, H, W, C) || n_parts != geo[0] ||
      C % 2 != 0 || !aligned(x, 4) || !aligned(dy, 4)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Args a = make_args(x, dy, nullptr, nullptr, partial, batch, H, W, C,
                           0, 0, 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = fuse_swish ? launch_bf16<kDw, true, false>(a, geo, s)
                   : launch_bf16<kDw, false, false>(a, geo, s);
  if (err != cudaSuccess) return (int)err;
  return reduce_parts(partial, dw, db, C, n_parts, s);
}

// Blocks of the bf16 forward (kind 0, swish and bias), dx (kind 1, swish')
// or dW/db stage 1 (kind 2, swish) that one SM holds at once with
// `threads` threads and `smem` bytes of dynamic shared memory, or -1 on an
// error.
extern "C" int nvae_dw5x5_bf16_blocks_per_sm(int kind, int threads, int smem,
                                            int device) {
  if (cudaSetDevice(device) != cudaSuccess) return -1;
  int n = -1;
  cudaError_t err = cudaSuccess;
  auto query = [&](auto kernel) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared);
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads,
                                                          smem);
    }
  };
  if (kind == kFwd) {
    if (threads <= 256) query(dw5x5_bf16<kFwd, true, true, 256>);
    else if (threads <= 512) query(dw5x5_bf16<kFwd, true, true, 512>);
    else query(dw5x5_bf16<kFwd, true, true, 1024>);
  } else if (kind == kDx) {
    if (threads <= 256) query(dw5x5_bf16<kDx, true, false, 256>);
    else if (threads <= 512) query(dw5x5_bf16<kDx, true, false, 512>);
    else query(dw5x5_bf16<kDx, true, false, 1024>);
  } else {
    if (threads <= 256) query(dw5x5_bf16<kDw, true, false, 256>);
    else if (threads <= 512) query(dw5x5_bf16<kDw, true, false, 512>);
    else query(dw5x5_bf16<kDw, true, false, 1024>);
  }
  return err == cudaSuccess ? n : -1;
}

extern "C" const char* nvae_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

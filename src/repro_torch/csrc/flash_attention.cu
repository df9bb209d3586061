// Hand-written Hopper (sm_90a) kernels for causal, windowed, soft-capped GQA
// attention with an online softmax (flash attention, forward only).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/flash_attention.py:
//   flash_wgmma_kernel (bf16 inputs)  <- _flash_kernel (flash_attention.py:22),
//   flash_kernel       (fp32 inputs)     pallas_call :100
//
// With q (B, H, S, d), k and v (B, Hkv, S, d), H % Hkv == 0, query head h
// reading kv head h / (H / Hkv), the softmax in fp32:
//   s  = q . k^T * (1/sqrt(d));  s = cap * tanh(s / cap) if cap > 0
//   valid(row, col) = col < S && (!causal || row >= col)
//                     && (window <= 0 || row - col < window)
//   s = valid ? s : -1e30;  online max m, sum-exp l and accumulator acc over
//   kv tiles, p = valid ? exp(s - m) : 0;  out = acc / max(l, 1e-30)
// out is (B, H, S, d), contiguous, in q's dtype (bf16 rounded to nearest).
//
// Two paths, chosen by dtype:
//
// bf16 (flash_wgmma_kernel).  Both products run on the tensor cores as
// wgmma.mma_async m64n64k16 with fp32 accumulators.  S = Q.K^T takes Q and K
// from shared memory (both K-major: d is contiguous).  The fp32 score is
// scaled by 1/sqrt(d) after the product (a bf16 x bf16 product is exact in
// fp32, so the score differs from the fp32 reference only by summation
// order), then capped, masked and put through the online softmax in fp32
// registers with expf, tanhf and IEEE division.  p is rounded to bf16 and
// O += P.V runs with P from registers (the S accumulator's fragment is the
// A operand's layout, so it converts in place) and V from shared memory
// (MN-major: d is contiguous, so the transpose bit is set).  l is summed
// from the fp32 p, as FlashAttention-2/3 do: bf16 keeps 8 significant
// bits, so rounding p moves each weight by at most 2^-8 of itself, and an
// output element by at most 2^-8 * sum_j p_j |v_j| / l (bf16_bound in
// kernels/flash_attention.py holds the kernel to that).
// What bounds it: operations, 4*d flops per attended (row, col) pair over
// the 989 TFLOP/s bf16 tensor-core peak (0.217 ms at Gemma 2's global
// layer, B 2, H 8, S 5120, d 256), plus the fp32 issue of expf and, with
// softcap, tanhf and a division on every score (~210 M of each at that
// shape; chip_smoke.py times that layer with and without the cap).  What
// the design does about it: a block of 384 threads takes 128
// query rows of one head.  One producer thread (warpgroup 2) copies Q and
// then each kv tile of 64 rows by TMA into two-stage K and V rings, 128-byte
// swizzled as the wgmma descriptors read them, as soon as the consumers
// release a stage (mbarriers both ways), so loads run two tiles ahead.  Two
// consumer warpgroups of 64 rows each issue S(t) together with
// P(t-1).V(t-1), wait for S(t) alone and run the softmax of tile t while
// P.V occupies the tensor cores; at d 128 and 256 they also take turns at
// issuing (named barriers), so that one's softmax runs while the other's
// products do.  setmaxnreg moves registers from the producer to the
// consumers (240 a thread: O takes d/2).  The division by the cap uses a
// hoisted reciprocal with one fma correction (div_by.cuh: equal to IEEE
// division for the caps checked, within an ulp of it for any), so the
// softmax is straight-line code.
// Shared memory at d 256: 64 KB of Q and 128 KB of K/V, one block an SM.
//
// fp32 (flash_kernel).  The reference computes in fp32, and TF32 would give
// that up, so fp32 inputs keep fp32 FMAs: q is scaled by 1/sqrt(d) before
// the product, as the reference does.  What bounds it: the same operations
// over the 67 TFLOP/s fp32 peak (3.2 ms at Gemma's shape).  The design: one
// block of 256 threads per (query tile of 64 rows, head, batch).  The block
// keeps its q tile, one 64-row k tile, one 64-row v tile and the 64 x 64
// probabilities in shared memory as fp32 (213,760 bytes at d 256), and
// walks the kv tiles in a loop that takes the place of the Pallas grid's
// sequential kv axis.  Thread (ty, tx) of a 16 x 16 grid owns rows ty + 16i
// (i < 4) of the tile: a 4 x 4 block of scores (columns tx + 16j) and a
// 4 x d/16 block of the accumulator (columns 64c + 4tx + e), so the row max
// and row sum are four shuffles within a half-warp and the accumulator
// never leaves registers.  Shared reads are 16-byte vectors; the q and k
// rows are padded by 4 floats so the k reads of a quarter-warp fall on
// distinct banks.
//
// Both: tiles that the causal mask or the window masks for every row of
// the query tile are skipped (exact: a fully masked tile changes neither m,
// l nor acc), and query tiles run latest first, so the longest rows start
// first.  q, k and v are taken with element strides for batch, head and
// time and a unit stride in the head dimension, so the (B, S, H, d) buffers
// that models/attention.py hands over through swapaxes views are read in
// place with no copy.  The bf16 path's tensor maps need 16-byte-aligned
// rows: base pointers 16-byte aligned and strides multiples of 8 elements
// (the entry point refuses anything else).  Head dims up to 256 are padded
// with zeros to 64, 128 or 256 in shared memory, and rows past S are zero.
// All offsets are 64-bit.  No fast math.
//
// Interface: plain C, bound with ctypes.  The entry points set the device,
// launch on the caller's stream, do not synchronise, allocate nothing and
// return cudaGetLastError().
#include <cuda.h>  // CUtensorMap and its enums (the encoder is fetched at run time)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "div_by.cuh"  // the softcap's division, shared with tools/check_division.cu
#include "wgmma.cuh"   // the wgmma helpers, shared with ssd_scan.cu

namespace {

constexpr int kMaxHeadDim = 256;
constexpr float kNeg = -1e30f;     // the reference's mask value
constexpr float kMinL = 1e-30f;    // the reference's floor on l

struct Strides {
  long long b, h, s;  // elements; the head dimension has stride 1
};

// ====================================================== fp32: FMA kernel
constexpr int kBQ = 64;            // query rows of a block
constexpr int kBK = 64;            // kv rows of a tile
constexpr int kThreads = 256;      // a 16 x 16 grid of threads
static_assert(kBQ == kBK, "load_tile moves 64-row tiles of q, k and v alike");

// Shared-memory layout for a padded head dim D (64, 128 or 256).
template <int D>
struct Tile {
  static constexpr int kLdQK = D + 4;   // q and k rows, padded against bank conflicts
  static constexpr int kLdP = kBK + 4;  // probability rows
  static constexpr int kFloats = kBQ * kLdQK + kBK * kLdQK + kBK * D + kBQ * kLdP;
  static constexpr size_t kBytes = sizeof(float) * kFloats;
};

// rows [row0, row0 + 64) of one head into a 64 x D fp32 tile with row
// stride ld, each value times mul; zero past S and past d.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* __restrict__ src,
                                          long long stride_s, int row0, int S, int d,
                                          float mul) {
  for (int idx = threadIdx.x; idx < kBK * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    const int row = row0 + r;
    float x = 0.f;
    if (row < S && c < d) x = src[(long long)row * stride_s + c] * mul;
    dst[r * ld + c] = x;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ out, int H, int group, int S,
             int d, Strides sq, Strides sk, Strides sv, int causal, int window, float softcap,
             float scale) {
  constexpr int kLdQK = Tile<D>::kLdQK, kLdP = Tile<D>::kLdP, kNC = D / 64;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // kBQ x kLdQK, pre-scaled
  float* Ks = Qs + kBQ * kLdQK;                 // kBK x kLdQK
  float* Vs = Ks + kBK * kLdQK;                 // kBK x D
  float* Ps = Vs + kBK * D;                     // kBQ x kLdP

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // latest query tile first
  const int h = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float* qh = q + b * sq.b + h * sq.h;
  const float* kh = k + b * sk.b + (long long)(h / group) * sk.h;
  const float* vh = v + b * sv.b + (long long)(h / group) * sv.h;

  load_tile<D>(Qs, kLdQK, qh, sq.s, q0, S, d, scale);

  float acc[4][kNC][4];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kNC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;
  }

  // kv tiles that some row of this query tile may attend
  const int last_row = min(q0 + kBQ, S) - 1;
  const int kt_end = causal ? last_row / kBK + 1 : (S + kBK - 1) / kBK;
  int kt_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) kt_begin = (q0 - window + 1) / kBK;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the last tile's readers are done (and Qs is written)
    load_tile<D>(Ks, kLdQK, kh, sk.s, k0, S, d, 1.f);
    load_tile<D>(Vs, D, vh, sv.s, k0, S, d, 1.f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int c = 0; c < D; c += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&Qs[(ty + 16 * i) * kLdQK + c]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * j) * kLdQK + c]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    // cap, mask, and the online-softmax update of this tile
    unsigned valid = 0u;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = q0 + ty + 16 * i, col = k0 + tx + 16 * j;
        float x = s[i][j];
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        const bool ok = col < S && (!causal || row >= col) && (window <= 0 || row - col < window);
        s[i][j] = ok ? x : kNeg;
        valid |= (ok ? 1u : 0u) << (4 * i + j);
      }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)  // the 16 lanes of this row
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = (valid >> (4 * i + j)) & 1u ? expf(s[i][j] - m_new) : 0.f;
        Ps[(ty + 16 * i) * kLdP + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kNC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][c][e] *= alpha;
    }
    __syncthreads();

    // acc += p . v
#pragma unroll 2
    for (int j = 0; j < kBK; j += 4) {
      float pv[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 t = *reinterpret_cast<const float4*>(&Ps[(ty + 16 * i) * kLdP + j]);
        pv[i][0] = t.x;
        pv[i][1] = t.y;
        pv[i][2] = t.z;
        pv[i][3] = t.w;
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int c = 0; c < kNC; ++c) {
          const float4 vv = *reinterpret_cast<const float4*>(&Vs[(j + jj) * D + 64 * c + 4 * tx]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][c][0] = fmaf(pv[i][jj], vv.x, acc[i][c][0]);
            acc[i][c][1] = fmaf(pv[i][jj], vv.y, acc[i][c][1]);
            acc[i][c][2] = fmaf(pv[i][jj], vv.z, acc[i][c][2]);
            acc[i][c][3] = fmaf(pv[i][jj], vv.w, acc[i][c][3]);
          }
        }
    }
  }

  float* oh = out + ((long long)b * H + h) * S * d;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
    const float denom = fmaxf(l[i], kMinL);
#pragma unroll
    for (int c = 0; c < kNC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 64 * c + 4 * tx + e;
        if (col < d) oh[(long long)row * d + col] = acc[i][c][e] / denom;
      }
  }
}

template <int D>
cudaError_t launch_fp32(const void* q, const void* k, const void* v, void* out, int B, int H,
                        int Hkv, int S, int d, Strides sq, Strides sk, Strides sv, int causal,
                        int window, float softcap, float scale, cudaStream_t stream) {
  const size_t smem = Tile<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(flash_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), H, H / Hkv, S, d, sq, sk, sv, causal, window, softcap, scale);
  return cudaGetLastError();
}

// ============================================ bf16: wgmma tensor-core kernel
namespace tc {

using namespace sm90;  // smem_u32, make_desc, the wgmma forms, pack_bf16 (wgmma.cuh)
using bf16 = __nv_bfloat16;
constexpr int kBQ = 128;           // query rows of a block: two consumer warpgroups of 64
constexpr int kBK = 64;            // kv rows of a tile
constexpr int kStages = 2;         // K and V ring depth
constexpr int kConsumers = 256;    // two warpgroups
constexpr int kThreads = kConsumers + 128;  // + a producer warpgroup (one thread issues the copies)

// Registers a thread keeps (setmaxnreg): the producer warpgroup gives what
// it does not need to the consumers, whose O accumulator takes d/2 of them.
// A block starts with 65536 / 384 = 168 a thread, and the shares balance:
// 128 * (168 - 24) = 256 * (240 - 168).
constexpr int kProducerRegs = 24, kConsumerRegs = 240;

// Shared memory for a padded head dim D: Q (kBQ x D), then kStages K tiles,
// then kStages V tiles (kBK x D each), every tile stored as D / 64 chunks
// of 64 columns, each chunk rows x 128 bytes, 128-byte swizzled; then the
// mbarriers of the K and V rings.
template <int D>
struct Smem {
  static constexpr int kQ = kBQ * D * 2;
  static constexpr int kKV = kBK * D * 2;
  static constexpr int kBarriers = kQ + 2 * kStages * kKV;   // 4 * kStages barriers of 8 bytes
  static constexpr int kBytes = kBarriers + 4 * kStages * 8 + kAtomBytes;  // + alignment slack
};

// One TMA copy: the box of 64 rows x 64 columns at coordinates (column,
// row, head, batch) of a tensor map into shared memory at dst, 128-byte
// swizzled as the map says; rows past S and columns past d arrive as zeros.
// Its bytes count toward bar's transaction.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int col, int row,
                                         int head, int batch, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(head), "r"(batch), "r"(bar)
      : "memory");
}

// --- mbarriers: a ring stage is "full" once the producer's copies landed
// (one arrival that expects their bytes) and "empty" once the 8 consumer
// warps read it.
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// arrives and expects that many bytes of copies before the phase completes
__device__ __forceinline__ void mbar_arrive_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// waits for the completion of the barrier's phase with this parity
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// The two consumer warpgroups take turns at issuing their products (named
// barriers 1 and 2), so that one's softmax runs while the other's products
// occupy the tensor cores.
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(kConsumers) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(2 - wg), "n"(kConsumers) : "memory");
}

// What a thread needs to mask and cap its scores of one kv tile: its first
// row, the column of its value 0, and the call's parameters.  rcap is
// 1 / softcap, and fast_div says softcap lies in the range that div_by was
// checked over (2^-20 to 2^20).
struct ScoreTile {
  int row0, col0, S, causal, window;
  float softcap, rcap, scale;
  bool fast_div;
};

// One 64 x 64 score tile of a warpgroup, in the accumulator layout below:
// s becomes p (fp32, 0 where masked); m, l and alpha (the factor for O) are
// this thread's two rows' running max, partial sum over its own columns and
// rescale.  kCap applies cap * tanh(s / cap) with IEEE division; kMask
// masks per element.
template <bool kCap, bool kMask>
__device__ __forceinline__ void softmax_tile(float (&s)[32], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], const ScoreTile& t) {
#pragma unroll
  for (int j = 0; j < 32; ++j) s[j] *= t.scale;
  if (kCap) {
    float hi = 0.f, lo = 0x1p100f;  // the largest |x| and the smallest nonzero |x|
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      hi = fmaxf(hi, fabsf(s[j]));
      lo = fminf(lo, s[j] == 0.f ? 0x1p100f : fabsf(s[j]));
    }
    if (__any_sync(0xffffffffu, !t.fast_div || !(hi <= 0x1p100f && lo >= 0x1p-100f))) {
#pragma unroll
      for (int j = 0; j < 32; ++j) s[j] = t.softcap * tanhf(s[j] / t.softcap);
    } else {
#pragma unroll
      for (int j = 0; j < 32; ++j) s[j] = t.softcap * tanhf(div_by(s[j], t.softcap, t.rcap));
    }
  }
  unsigned valid = 0xffffffffu;
  float mx[2] = {kNeg, kNeg};
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    if (kMask) {
      const int row = t.row0 + 8 * ((j >> 1) & 1), col = t.col0 + 8 * (j >> 2) + (j & 1);
      const bool ok = col < t.S && (!t.causal || row >= col) && (t.window <= 0 || row - col < t.window);
      s[j] = ok ? s[j] : kNeg;
      valid &= ok ? 0xffffffffu : ~(1u << j);
    }
    mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], s[j]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // the 4 lanes of a row
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    alpha[r] = expf(m[r] - m_new);
    m[r] = m_new;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int r = (j >> 1) & 1;
    float p = expf(s[j] - m[r]);
    if (kMask) p = (valid >> j) & 1u ? p : 0.f;
    l[r] += p;
    s[j] = p;
  }
}

// The accumulators are in wgmma.cuh's register layout.
//
// Thread 256 produces: it copies Q and then each kv tile's K and V into the
// rings by TMA as soon as their stage is free.  Warps 0-7 (two warpgroups of 64
// query rows) consume: at tile t a warpgroup issues S(t) = Q.K(t)^T and
// O += P(t-1).V(t-1) together, waits for S(t) alone, runs the softmax of
// tile t while P.V runs on the tensor cores, then waits for P.V, rescales O
// and rounds P(t) to bf16.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                   const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v, bf16* __restrict__ out, int H,
                   int group, int S, int d, int causal, int window, float softcap, float scale) {
  constexpr int kNC = D / 64;  // 64-column chunks of d
  extern __shared__ uint8_t smem_raw[];
  const uint32_t Qs = (smem_u32(smem_raw) + kAtomBytes - 1) & ~uint32_t(kAtomBytes - 1);
  const uint32_t Ks = Qs + Smem<D>::kQ;              // kStages K tiles
  const uint32_t Vs = Ks + kStages * Smem<D>::kKV;   // kStages V tiles
  const uint32_t bar = Qs + Smem<D>::kBarriers;      // full K, full V, empty K, empty V
  const auto full_k = [&](int st) { return bar + 8 * st; };
  const auto full_v = [&](int st) { return bar + 8 * (kStages + st); };
  const auto empty_k = [&](int st) { return bar + 8 * (2 * kStages + st); };
  const auto empty_v = [&](int st) { return bar + 8 * (3 * kStages + st); };

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // latest query tile first
  const int h = blockIdx.y, b = blockIdx.z;
  // the warp index through a shuffle, so the compiler sees it is uniform
  // across the warp and keeps the products out of divergent code
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0), lane = threadIdx.x & 31;

  // kv tiles that some row of this query tile may attend
  const int last_row = min(q0 + kBQ, S) - 1;
  const int kt_end = causal ? last_row / kBK + 1 : (S + kBK - 1) / kBK;
  int kt_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) kt_begin = (q0 - window + 1) / kBK;
  const int n_tiles = kt_end - kt_begin;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full_k(st), 1);
      mbar_init(full_v(st), 1);
      mbar_init(empty_k(st), kConsumers / 32);
      mbar_init(empty_v(st), kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumers / 32) {  // --------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x != kConsumers) return;  // one thread issues the copies
    const int hk = h / group;
    for (int t = 0; t < n_tiles; ++t) {
      const int st = t % kStages, parity = ((t / kStages) & 1) ^ 1, k0 = (kt_begin + t) * kBK;
      mbar_wait(empty_k(st), parity);
      mbar_arrive_expect(full_k(st), Smem<D>::kKV + (t == 0 ? Smem<D>::kQ : 0));
      if (t == 0)  // Q rides on tile 0's barrier
        for (int c = 0; c < D / 64; ++c)
          for (int r = 0; r < kBQ; r += 64)
            tma_load(Qs + c * (kBQ * kRowBytes) + r * kRowBytes, &map_q, 64 * c, q0 + r, h, b,
                     full_k(0));
      for (int c = 0; c < D / 64; ++c)
        tma_load(Ks + st * Smem<D>::kKV + c * (kBK * kRowBytes), &map_k, 64 * c, k0, hk, b,
                 full_k(st));
      mbar_wait(empty_v(st), parity);
      mbar_arrive_expect(full_v(st), Smem<D>::kKV);
      for (int c = 0; c < D / 64; ++c)
        tma_load(Vs + st * Smem<D>::kKV + c * (kBK * kRowBytes), &map_v, 64 * c, k0, hk, b,
                 full_v(st));
    }
  } else {  // ------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int wg = warp >> 2;
    const int row0 = q0 + 64 * wg + 16 * (warp & 3) + (lane >> 2);  // rows row0, row0 + 8
    const int wg_first = q0 + 64 * wg, wg_last = min(wg_first + 63, S - 1);
    const uint32_t Qw = Qs + wg * (64 * kRowBytes);
    ScoreTile tile{row0, 0, S, causal, window, softcap, 0.f, scale, false};
    if (softcap > 0.f) {
      tile.rcap = 1.f / softcap;
      tile.fast_div = softcap >= 0x1p-20f && softcap <= 0x1p20f;
    }

    float o[kNC][32];
#pragma unroll
    for (int c = 0; c < kNC; ++c)
#pragma unroll
      for (int j = 0; j < 32; ++j) o[c][j] = 0.f;
    float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};  // l: this thread's columns only
    float s[32], alpha[2];
    uint32_t pa[4][4];  // P of the last tile, bf16 pairs

    // Every warpgroup runs every tile of the block: a tile that masks all of
    // its rows leaves m, l and O as they are, and keeping the products out
    // of divergent code lets them run asynchronously.
    const auto issue_s = [&](int t) {  // S = Q . K(t)^T
      const uint32_t Kt = Ks + (t % kStages) * Smem<D>::kKV;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)  // k16 steps: chunk kk / 4, 32 bytes each
        wgmma_ss(s, make_desc(Qw + (kk >> 2) * (kBQ * kRowBytes) + (kk & 3) * 32),
                 make_desc(Kt + (kk >> 2) * (kBK * kRowBytes) + (kk & 3) * 32), kk > 0);
      wgmma_commit();
    };
    const auto issue_pv = [&](int t) {  // O += P(t) . V(t)
      const uint32_t Vt = Vs + (t % kStages) * Smem<D>::kKV;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // kv rows 16kk..16kk+15: two 8-row atoms
#pragma unroll
        for (int c = 0; c < kNC; ++c)
          wgmma_rs(o[c], pa[kk], make_desc(Vt + c * (kBK * kRowBytes) + kk * 2 * kAtomBytes));
      wgmma_commit();
    };
    // scale, cap, mask and the online softmax of tile t, each case in
    // straight-line code; then this warp is done with K(t)
    const auto softmax = [&](int t) {
      fence_regs(s);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_k(t % kStages));
      const int k0 = (kt_begin + t) * kBK;
      tile.col0 = k0 + 2 * (lane & 3);
      const bool need_mask = k0 + kBK > S || (causal && k0 + kBK - 1 > wg_first) ||
                             (window > 0 && wg_last - k0 >= window);
      if (softcap > 0.f) {
        if (need_mask) softmax_tile<true, true>(s, m, l, alpha, tile);
        else softmax_tile<true, false>(s, m, l, alpha, tile);
      } else {
        if (need_mask) softmax_tile<false, true>(s, m, l, alpha, tile);
        else softmax_tile<false, false>(s, m, l, alpha, tile);
      }
    };
    const auto pack_p = [&]() {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) pa[kk][i] = pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
    };
    const auto pv_done = [&](int t) {  // after wgmma_wait: this warp is done with V(t)
#pragma unroll
      for (int c = 0; c < kNC; ++c) fence_regs(o[c]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) fence_regs(pa[kk]);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_v(t % kStages));
    };

    // Turns pay at d 128 and 256; at d 64 the softmax is short, and on an
    // H100 they cost more than they gave.
    constexpr bool kTurns = D > 64;
    if (kTurns && wg == 1) turn_pass(wg);  // the first turn is warpgroup 0's
    // tile 0: S(0) alone
    mbar_wait(full_k(0), 0);
    if (kTurns) turn_wait(wg);
    wgmma_fence();
    issue_s(0);
    if (kTurns) turn_pass(wg);
    wgmma_wait<0>();
    softmax(0);
    pack_p();
    // tile t: S(t) and P(t-1).V(t-1) together; the softmax of tile t runs
    // while P.V does
    for (int t = 1; t < n_tiles; ++t) {
      mbar_wait(full_k(t % kStages), (t / kStages) & 1);
      mbar_wait(full_v((t - 1) % kStages), ((t - 1) / kStages) & 1);
      if (kTurns) turn_wait(wg);
      wgmma_fence();
      issue_s(t);
      issue_pv(t - 1);
      if (kTurns) turn_pass(wg);
      wgmma_wait<1>();
      softmax(t);
      wgmma_wait<0>();
      pv_done(t - 1);
#pragma unroll
      for (int c = 0; c < kNC; ++c)
#pragma unroll
        for (int j = 0; j < 32; ++j) o[c][j] *= alpha[(j >> 1) & 1];
      pack_p();
    }
    // the last P.V
    mbar_wait(full_v((n_tiles - 1) % kStages), ((n_tiles - 1) / kStages) & 1);
    if (kTurns) turn_wait(wg);
    wgmma_fence();
    issue_pv(n_tiles - 1);
    if (kTurns && wg == 0) turn_pass(wg);  // every wait has its pass
    wgmma_wait<0>();
    pv_done(n_tiles - 1);

    // the 4 lanes of a row hold partial sums of l over their columns
    float denom[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      denom[r] = fmaxf(l[r], kMinL);
    }
    bf16* oh = out + ((long long)b * H + h) * S * d;
#pragma unroll
    for (int c = 0; c < kNC; ++c)
#pragma unroll
      for (int j = 0; j < 32; j += 2) {
        const int row = row0 + 8 * ((j >> 1) & 1);
        const int col = 64 * c + 8 * (j >> 2) + 2 * (lane & 3);
        if (row >= S || col >= d) continue;
        const float y0 = o[c][j] / denom[(j >> 1) & 1], y1 = o[c][j + 1] / denom[(j >> 1) & 1];
        bf16* dst = oh + (long long)row * d + col;
        if (col + 1 < d && (d & 1) == 0) {
          *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(y0, y1);
        } else {
          dst[0] = __float2bfloat16_rn(y0);
          if (col + 1 < d) dst[1] = __float2bfloat16_rn(y1);
        }
      }
  }
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no link to
// libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                     &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A rank-4 map (column, row, head, batch) over a (B, heads, S, d) bf16 view
// with element strides st, read in boxes of 64 x 64, 128-byte swizzled.  A
// dim of size 1 is never stepped, so its stride is replaced by one the
// encoder takes.
bool make_map(CUtensorMap* map, const void* base, int B, int heads, int S, int d, Strides st) {
  const EncodeTiled encode = encoder();
  if (!encode) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)S, (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint64_t strides[3] = {S > 1 ? 2ull * st.s : 16ull, heads > 1 ? 2ull * st.h : 16ull,
                                 B > 1 ? 2ull * st.b : 16ull};
  const cuuint32_t box[4] = {64, (cuuint32_t)kBK, 1, 1}, unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B, int H, int Hkv,
                   int S, int d, Strides sq, Strides sk, Strides sv, int causal, int window,
                   float softcap, float scale, cudaStream_t stream) {
  CUtensorMap map_q, map_k, map_v;
  if (!make_map(&map_q, q, B, H, S, d, sq) || !make_map(&map_k, k, B, Hkv, S, d, sk) ||
      !make_map(&map_v, v, B, Hkv, S, d, sv))
    return cudaErrorInvalidValue;
  const int smem = Smem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(flash_wgmma_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_wgmma_kernel<D><<<grid, kThreads, smem, stream>>>(
      map_q, map_k, map_v, static_cast<bf16*>(out), H, H / Hkv, S, d, causal, window, softcap,
      scale);
  return cudaGetLastError();
}

}  // namespace tc

bool bad_shape(int B, int H, int Hkv, int S, int d) {
  return B < 1 || H < 1 || Hkv < 1 || H % Hkv || S < 1 || d < 1 || d > kMaxHeadDim;
}

// bf16 rows are copied 16 bytes at a time: every row start must be 16-byte
// aligned (the stride of a dim of size 1 is never stepped)
bool misaligned(const void* p, Strides s, int B, int heads, int S) {
  return reinterpret_cast<uintptr_t>(p) % 16 || (B > 1 && s.b % 8) || (heads > 1 && s.h % 8) ||
         (S > 1 && s.s % 8);
}

}  // namespace

extern "C" {

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// out (B, H, S, d) contiguous = attention(q, k, v); q (B, H, S, d) and k, v
// (B, Hkv, S, d) given by element strides (batch, head, time) with a unit
// head-dim stride; all four fp32.  window <= 0 and softcap <= 0 turn those
// features off.  scale multiplies q before the product.
int flash_attention_fp32(const void* q, const void* k, const void* v, void* out, int B, int H,
                         int Hkv, int S, int d, long long q_sb, long long q_sh, long long q_ss,
                         long long k_sb, long long k_sh, long long k_ss, long long v_sb,
                         long long v_sh, long long v_ss, int causal, int window, float softcap,
                         float scale, int device, void* stream) {
  if (bad_shape(B, H, Hkv, S, d)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Strides sq{q_sb, q_sh, q_ss}, sk{k_sb, k_sh, k_ss}, sv{v_sb, v_sh, v_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 64)
    return (int)launch_fp32<64>(q, k, v, out, B, H, Hkv, S, d, sq, sk, sv, causal, window,
                                softcap, scale, s);
  if (d <= 128)
    return (int)launch_fp32<128>(q, k, v, out, B, H, Hkv, S, d, sq, sk, sv, causal, window,
                                 softcap, scale, s);
  return (int)launch_fp32<256>(q, k, v, out, B, H, Hkv, S, d, sq, sk, sv, causal, window,
                               softcap, scale, s);
}

// The same for bf16 q, k, v and out, on the tensor cores; scale multiplies
// the fp32 score after the product.  q, k and v must be 16-byte aligned
// with strides that are multiples of 8 elements (else
// cudaErrorMisalignedAddress).
int flash_attention_bf16(const void* q, const void* k, const void* v, void* out, int B, int H,
                         int Hkv, int S, int d, long long q_sb, long long q_sh, long long q_ss,
                         long long k_sb, long long k_sh, long long k_ss, long long v_sb,
                         long long v_sh, long long v_ss, int causal, int window, float softcap,
                         float scale, int device, void* stream) {
  if (bad_shape(B, H, Hkv, S, d)) return (int)cudaErrorInvalidValue;
  const Strides sq{q_sb, q_sh, q_ss}, sk{k_sb, k_sh, k_ss}, sv{v_sb, v_sh, v_ss};
  if (misaligned(q, sq, B, H, S) || misaligned(k, sk, B, Hkv, S) || misaligned(v, sv, B, Hkv, S))
    return (int)cudaErrorMisalignedAddress;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 64)
    return (int)tc::launch<64>(q, k, v, out, B, H, Hkv, S, d, sq, sk, sv, causal, window,
                               softcap, scale, s);
  if (d <= 128)
    return (int)tc::launch<128>(q, k, v, out, B, H, Hkv, S, d, sq, sk, sv, causal, window,
                                softcap, scale, s);
  return (int)tc::launch<256>(q, k, v, out, B, H, Hkv, S, d, sq, sk, sv, causal, window,
                              softcap, scale, s);
}

}  // extern "C"

// Hand-written Hopper (sm_90a) kernels for the Mamba2 SSD chunked scan
// (state-space duality), forward only.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/ssd_scan.py:
//   chunk_state_kernel, state_pass_kernel,  <- _ssd_kernel (ssd_scan.py:24),
//   chunk_output_kernel (bf16 inputs);         pallas_call :84
//   ssd_kernel (fp32 inputs)
//
// With x (b, l, h, p) already scaled by dt, a (b, l, h) = A*dt <= 0 and
// B, C (b, l, h, n), for each (batch, head), chunk after chunk of
// positions, every sum in fp32 and the state starting at zero:
//   a_cum = cumsum(a)                                   (within the chunk)
//   L[i][j] = exp(i >= j ? a_cum[i] - a_cum[j] : -1e30)
//   y = ((C . B^T) * L) . x + exp(a_cum) * (C . state^T)
//   state <- exp(a_cum[-1]) * state + x^T . (B * exp(a_cum[-1] - a_cum))
// y is (b, l, h, p), contiguous, in x's dtype (bf16 rounded to nearest);
// the final state, when asked for, is (b, h, p, n) fp32, contiguous.
//
// Two paths, chosen by dtype:
//
// bf16: the chunk-parallel SSD (Mamba2 paper, arXiv:2405.21060 sections
// 6-7) in three passes, every product on the tensor cores (wgmma m64n64k16,
// fp32 accumulators; wgmma.cuh).  Chunks of kChunk = 128 positions:
//   1. chunk_state_kernel, grid (chunk x p tile, head, batch): a_cum, then
//      S_c = x^T . (B * exp(a_cum[-1] - a_cum)) and the chunk's decay
//      exp(a_cum[-1]) into an fp32 workspace (b, h, c, p, n) and (b, h, c);
//   2. state_pass_kernel, one thread per (batch, head, p*n element): in the
//      plain version's order, entering[c] = s, s = decay[c]*s + S_c (S_c is
//      overwritten by entering[c]); the last s is the final state;
//   3. chunk_output_kernel, grid (chunk x p tile, head, batch): y =
//      exp(a_cum) * (C . entering^T) + ((C . B^T) * L) . x, rounded once.
// Why the chunk-parallel form: every pass but the short state pass is
// parallel over (chunk, head, batch), so a call fills the 132 SMs at any
// batch (768 blocks a pass at one mamba2-130m prompt of 4096 tokens),
// where a loop over the chunks inside a block gave 96 blocks at b = 1.
// Why Q = 128: the workspace holds b*h*(l/Q)*p*n fp32 values and is
// written, read and rewritten, and read again (100.7 MB at mamba2-130m's
// 4 x 4096 tokens, 24 heads, p 64, n 128), so Q = 64 would double those
// bytes; Q = 256 would double the quadratic products' operations, and C
// and B alone (2 x 256 x 128 bf16) would leave one block an SM.  128 is
// also the reference's default chunk.
// Precision: x, B and C arrive in bf16, so they are exact wgmma operands
// and C . B^T is exact products summed in fp32.  Each fp32 operand (the
// masked scores, x * decay, the entering state) is split into a bf16 pair
// hi = bf16(v), lo = bf16(v - hi), and both halves are multiplied against
// the exact operand into one fp32 accumulator: the residual is at most
// 2^-16 |v|, so every product is fp32-class and the kernel is held to the
// fp32 state gate.  The score decay L is 2^((a_cum[i] - a_cum[j]) log2 e)
// on the special-function unit (ex2.approx): its absolute error, at most
// ~2^-22 + |x| e^x 2^-24 < 3e-7, is far under the split's residual, at a
// few instructions where an accurate expf takes several times as many on
// every score; the chunk decays and exp(a_cum) stay expf.
// What bounds it: bytes.  x read twice, y written, B and C read (once a
// head-broadcast view), a, and the workspace (written, read, rewritten,
// read) over 3.35 TB/s; the products (~45 GFLOP at mamba2-130m's shape,
// hi/lo halves counted) are far under the 989 TFLOP/s bf16 peak.
// Loads: 16-byte cp.async copies into 128-byte-swizzled tiles (the layout
// the descriptors read) where the source row is 16-byte aligned, else
// element by element (e.g. a broadcast B at n = 100 has a 200-byte time
// stride); rows past l and columns past n or p are zero, which leaves every
// sum exact.  n is padded to 64 or 128, p tiles are 64 wide.
//
// fp32 (ssd_kernel): the reference computes in fp32 and TF32 would give
// that up, so fp32 inputs keep fp32 FMAs, bound by the 67 TFLOP/s fp32
// peak (~0.48 ms at mamba2-130m's shape).  The design:
// - The Pallas grid's sequential chunk axis becomes a loop inside the
//   block, over tiles of 64 positions; the state never leaves the block: a
//   thread keeps its share of it in registers and mirrors it to shared
//   memory (double-buffered, so a tile's outputs read the state entering it
//   while the same tile writes the state it hands on).
// - Filling 132 SMs: a block per (batch, head) would be 96 blocks for
//   mamba2-130m at 4 prompts and 128 for zamba2-1.2b at 2.  Given the
//   64 x 64 scores, the p columns of y and of the state are independent,
//   so the grid is (p tiles of 16, head, batch): 384 and 512 blocks.  Each
//   block recomputes the scores for its p tile; causal 16 x 16 sub-blocks
//   wholly above the diagonal are skipped (exact: they are masked to 0).
// - Shared memory: the B and C tiles in fp32 (64 x (n + 1) each; n is
//   padded with zeros to 32, 64 or 128), the x tile (64 x 16), the masked
//   scores (64 x 65) and the state (2 x n x 17): 104,964 bytes at n 128, so
//   two blocks fit an SM; the launch opts into more than 48 KB.  Row pitches
//   are odd, so the column reads of a warp fall on distinct banks.
//
// Both: B and C are read through batch, time and head strides with a unit
// stride in n, so the head-broadcast views that models/ssm.py passes (head
// stride 0) are read in place and no (b, l, h, n) copy is made.  Grouped B
// and C (b, l, g, n), g dividing h, are read in place too: head h reads
// group h / (h_total / g), as Mamba2's n_groups > 1 (Nemotron-H: 64 heads,
// 8 groups), through the same pointer arithmetic at heads_per_group > 1.  The
// segment sums are the reference's cumsum differences, all exps have
// arguments <= 0, no fast math (expf; the bf16 score decay aside, above).  Positions at or past l load x = 0,
// a = 0 and B = C = 0, so a ragged tail leaves the state exact (decay
// exp(0), nothing added) and is never written to y.  All offsets are 64-bit.
//
// Interface: plain C, bound with ctypes.  The entry point sets the device,
// launches on the caller's stream, does not synchronise, allocates nothing
// (the bf16 path's workspace comes from the caller) and returns
// cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr int kQ = 64;             // positions of a tile
constexpr int kPT = 16;            // p columns of a block
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxState = 128;
constexpr float kNeg = -1e30f;     // the reference's mask value
static_assert(kQ == 64 && kPT == 16 && kThreads == 256,
              "the thread mappings below assume 64 x 16 tiles and 256 threads");

enum Dtype { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }

struct Strides {
  long long b, s, h;  // elements: batch, time, head; the last dim has stride 1
  int r = 1;          // heads that read one row of the head dim (B and C's groups)
  // the row of batch bi and head hi: head hi reads row hi / r
  __device__ __forceinline__ long long at(int bi, int hi) const {
    return bi * b + (long long)(hi / r) * h;
  }
};

// Shared-memory layout for a padded state dim NP (32, 64 or 128).
template <int NP>
struct Smem {
  static constexpr int kLdN = NP + 1;   // B and C rows
  static constexpr int kLdS = kQ + 1;   // score rows
  static constexpr int kLdT = kPT + 1;  // state rows, n-major
  static constexpr int kFloats =
      2 * kQ * kLdN + kQ * kPT + kQ * kLdS + 2 * NP * kLdT + 3 * kQ + 1;
  static constexpr size_t kBytes = sizeof(float) * kFloats;
};

template <typename T, int NP>
__global__ void __launch_bounds__(kThreads, 2)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ a, const T* __restrict__ Bm,
           const T* __restrict__ Cm, T* __restrict__ y, float* __restrict__ state_out,
           int L, int H, int P, int N, Strides sx, Strides sa, Strides sb, Strides sc) {
  using S = Smem<NP>;
  constexpr int kLdN = S::kLdN, kLdS = S::kLdS, kLdT = S::kLdT;
  constexpr int kNK = NP / 32;          // state columns n = lane + 32k of a thread
  constexpr int kPR = kPT / kWarps;     // state rows p = warp + 8r of a thread
  extern __shared__ float smem[];
  float* Cs = smem;                     // kQ x kLdN
  float* Bs = Cs + kQ * kLdN;           // kQ x kLdN
  float* Xs = Bs + kQ * kLdN;           // kQ x kPT
  float* Ss = Xs + kQ * kPT;            // kQ x kLdS, the masked scores
  float* St = Ss + kQ * kLdS;           // 2 x NP x kLdT, state[p][n] at [n][p]
  float* Acum = St + 2 * NP * kLdT;     // a_cum
  float* Ea = Acum + kQ;                // exp(a_cum)
  float* Dec = Ea + kQ;                 // exp(a_cum[-1] - a_cum)
  float* Elast = Dec + kQ;              // exp(a_cum[-1])

  const int p0 = blockIdx.x * kPT, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = tid & 15, ty = tid >> 4;
  const T* xh = x + b * sx.b + h * sx.h + p0;
  const float* ah = a + b * sa.b + h * sa.h;
  const T* bh = Bm + sb.at(b, h);
  const T* ch = Cm + sc.at(b, h);
  T* yh = y + ((long long)b * L * H + h) * P + p0;
  const long long y_ss = (long long)H * P;

  float st[kPR][kNK];
#pragma unroll
  for (int r = 0; r < kPR; ++r)
#pragma unroll
    for (int k = 0; k < kNK; ++k) st[r][k] = 0.f;
  for (int i = tid; i < NP * kLdT; i += kThreads) St[i] = 0.f;

  const int n_tiles = (L + kQ - 1) / kQ;
  for (int c = 0; c < n_tiles; ++c) {
    const int t0 = c * kQ;
    const float* St_in = St + (c & 1) * NP * kLdT;
    float* St_out = St + ((c + 1) & 1) * NP * kLdT;

    // ---- load the tile: B, C (zero past l and past n), x (zero past l, p)
    for (int idx = tid; idx < kQ * NP; idx += kThreads) {
      const int r = idx / NP, col = idx % NP, t = t0 + r;
      float bv = 0.f, cv = 0.f;
      if (t < L && col < N) {
        bv = to_f32(bh[t * sb.s + col]);
        cv = to_f32(ch[t * sc.s + col]);
      }
      Bs[r * kLdN + col] = bv;
      Cs[r * kLdN + col] = cv;
    }
    for (int idx = tid; idx < kQ * kPT; idx += kThreads) {
      const int r = idx / kPT, col = idx % kPT, t = t0 + r;
      Xs[idx] = (t < L && p0 + col < P) ? to_f32(xh[t * sx.s + col]) : 0.f;
    }
    if (warp == 0) {
      // inclusive cumsum of a over the tile, two positions a lane
      const int r0 = 2 * lane;
      const float a0 = t0 + r0 < L ? ah[(t0 + r0) * sa.s] : 0.f;
      const float a1 = t0 + r0 + 1 < L ? ah[(t0 + r0 + 1) * sa.s] : 0.f;
      const float pair = a0 + a1;
      float incl = pair;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += up;
      }
      float before = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) before = 0.f;
      const float cum0 = before + a0, cum1 = before + pair;
      const float last = __shfl_sync(0xffffffffu, cum1, 31);
      Acum[r0] = cum0;
      Acum[r0 + 1] = cum1;
      Ea[r0] = expf(cum0);
      Ea[r0 + 1] = expf(cum1);
      Dec[r0] = expf(last - cum0);
      Dec[r0 + 1] = expf(last - cum1);
      if (lane == 0) *Elast = expf(last);
    }
    __syncthreads();

    // ---- scores: Ss[i][j] = (C_i . B_j) * L[i][j]; thread (ty, tx) owns
    // rows ty + 16ii and columns tx + 16jj, and skips jj > ii (all masked)
    {
      float acc[4][4];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[ii][jj] = 0.f;
#pragma unroll 4
      for (int k = 0; k < NP; ++k) {
        float cv[4], bv[4];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) cv[ii] = Cs[(ty + 16 * ii) * kLdN + k];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) bv[jj] = Bs[(tx + 16 * jj) * kLdN + k];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int jj = 0; jj <= ii; ++jj) acc[ii][jj] = fmaf(cv[ii], bv[jj], acc[ii][jj]);
      }
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int i = ty + 16 * ii, j = tx + 16 * jj;
          float s = 0.f;
          if (jj <= ii) s = acc[ii][jj] * expf(i >= j ? Acum[i] - Acum[j] : kNeg);
          Ss[i * kLdS + j] = s;
        }
    }
    __syncthreads();

    // ---- outputs: thread (ty, tx) owns rows ty + 16r of column p0 + tx;
    // row i needs scores j <= i only, which lie in j < 16(r + 1)
    {
      float acc[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ty + 16 * r;
        float s = 0.f;
        for (int j = 0; j < 16 * (r + 1); ++j)
          s = fmaf(Ss[i * kLdS + j], Xs[j * kPT + tx], s);
        acc[r] = s;
      }
      float off[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int k = 0; k < NP; ++k) {
        const float sv = St_in[k * kLdT + tx];
#pragma unroll
        for (int r = 0; r < 4; ++r) off[r] = fmaf(Cs[(ty + 16 * r) * kLdN + k], sv, off[r]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ty + 16 * r, t = t0 + i;
        if (t < L && p0 + tx < P) yh[t * y_ss + tx] = from_f32<T>(acc[r] + Ea[i] * off[r]);
      }
    }

    // ---- the state handed on: thread owns p = warp + 8r, n = lane + 32k
    {
      float add[kPR][kNK];
#pragma unroll
      for (int r = 0; r < kPR; ++r)
#pragma unroll
        for (int k = 0; k < kNK; ++k) add[r][k] = 0.f;
#pragma unroll 4
      for (int j = 0; j < kQ; ++j) {
        const float dec = Dec[j];
        float bd[kNK];
#pragma unroll
        for (int k = 0; k < kNK; ++k) bd[k] = Bs[j * kLdN + lane + 32 * k] * dec;
#pragma unroll
        for (int r = 0; r < kPR; ++r) {
          const float xv = Xs[j * kPT + warp + kWarps * r];
#pragma unroll
          for (int k = 0; k < kNK; ++k) add[r][k] = fmaf(xv, bd[k], add[r][k]);
        }
      }
      const float elast = *Elast;
#pragma unroll
      for (int r = 0; r < kPR; ++r)
#pragma unroll
        for (int k = 0; k < kNK; ++k) {
          st[r][k] = elast * st[r][k] + add[r][k];
          St_out[(lane + 32 * k) * kLdT + warp + kWarps * r] = st[r][k];
        }
    }
    __syncthreads();
  }

  if (state_out != nullptr) {
#pragma unroll
    for (int r = 0; r < kPR; ++r)
#pragma unroll
      for (int k = 0; k < kNK; ++k) {
        const int p = p0 + warp + kWarps * r, n = lane + 32 * k;
        if (p < P && n < N) state_out[(((long long)b * H + h) * P + p) * N + n] = st[r][k];
      }
  }
}

template <typename T, int NP>
cudaError_t launch(const void* x, const float* a, const void* Bm, const void* Cm, void* y,
                   float* state, int Bsz, int L, int H, int P, int N, Strides sx, Strides sa,
                   Strides sb, Strides sc, cudaStream_t stream) {
  const size_t smem = Smem<NP>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(ssd_kernel<T, NP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((P + kPT - 1) / kPT, H, Bsz);
  ssd_kernel<T, NP><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), a, static_cast<const T*>(Bm), static_cast<const T*>(Cm),
      static_cast<T*>(y), state, L, H, P, N, sx, sa, sb, sc);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const float* a, const void* Bm, const void* Cm, void* y,
                     float* state, int Bsz, int L, int H, int P, int N, Strides sx, Strides sa,
                     Strides sb, Strides sc, cudaStream_t stream) {
  if (N <= 32)
    return launch<T, 32>(x, a, Bm, Cm, y, state, Bsz, L, H, P, N, sx, sa, sb, sc, stream);
  if (N <= 64)
    return launch<T, 64>(x, a, Bm, Cm, y, state, Bsz, L, H, P, N, sx, sa, sb, sc, stream);
  return launch<T, 128>(x, a, Bm, Cm, y, state, Bsz, L, H, P, N, sx, sa, sb, sc, stream);
}

// ============================================ bf16: chunk-parallel, wgmma
namespace tc {

using namespace sm90;  // swizzled tiles, descriptors, the wgmma forms (wgmma.cuh)
using bf16 = __nv_bfloat16;
constexpr int kChunk = 128;        // positions of a chunk (see the note above)
constexpr int kPT = 64;            // p columns of a block: one wgmma tile
constexpr int kThreads = 256;      // two warpgroups
constexpr int kPassThreads = 256;  // the state pass
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kChunk == 128 && kPT == 64 && kThreads == 256,
              "the warpgroup mappings below assume 128 x 64 tiles and 256 threads");

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}
// 2^x by the special-function unit (relative error ~2^-22; results under
// 2^-126 flush to zero).
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Waits for this thread's cp.async copies and makes its shared-memory
// writes (copies and stores) visible to the async proxy, which the wgmma
// operands are read through; a barrier follows.
__device__ __forceinline__ void tiles_written() {
  asm volatile(
      "cp.async.commit_group;\ncp.async.wait_group 0;\n"
      "fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void st_shared_v4(uint32_t dst, const uint32_t (&w)[4]) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst), "r"(w[0]), "r"(w[1]),
               "r"(w[2]), "r"(w[3])
               : "memory");
}

// Rows start 16-byte aligned: the base and the row stride (elements).
__device__ __forceinline__ bool rows_aligned16(const void* p, long long stride_elems,
                                               int elem_bytes) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0 && ((stride_elems * elem_bytes) & 15) == 0;
}

__device__ __forceinline__ uint32_t bf16_bits(bf16 v) { return __bfloat16_as_ushort(v); }

// A bf16 pair in one register, the first value in the low half.
__device__ __forceinline__ uint32_t pack_bits(bf16 lo, bf16 hi) {
  return bf16_bits(lo) | (bf16_bits(hi) << 16);
}

// v into hi = bf16(v) and lo = bf16(v - hi), pairwise: (v0, v1) -> one
// register of each.
__device__ __forceinline__ void split_pair(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  const bf16 h0 = __float2bfloat16_rn(v0), h1 = __float2bfloat16_rn(v1);
  hi = pack_bits(h0, h1);
  lo = pack_bf16(v0 - __bfloat162float(h0), v1 - __bfloat162float(h1));
}

// Rows [0, R) x columns [0, W) of a bf16 matrix (row r at src + r * ss,
// unit column stride) into a swizzled tile at dst: 16-byte cp.async copies
// where the rows are 16-byte aligned (vec), else element by element; zero
// at rows >= n_rows and columns >= n_cols.  The caller waits with
// tiles_written and a barrier.
template <int R, int W>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* __restrict__ src,
                                          long long ss, int n_rows, int n_cols, bool vec) {
  constexpr int kUnits = W / 8;
  for (int u = threadIdx.x; u < R * kUnits; u += kThreads) {
    const int r = u / kUnits, col = (u % kUnits) * 8;
    const uint32_t to = dst + swizzle_off(r, col, R);
    if (vec && r < n_rows && col + 8 <= n_cols) {
      cp_async16(to, src + r * ss + col);
    } else {
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      if (r < n_rows) {
        const bf16* row = src + r * ss;
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (col + e < n_cols) w[e >> 1] |= bf16_bits(row[col + e]) << (16 * (e & 1));
      }
      st_shared_v4(to, w);
    }
  }
}

// Eight values of a bf16 row into fp32 (zero past n_rows / n_cols).
__device__ __forceinline__ void load8(const bf16* __restrict__ src, long long ss, int r, int col,
                                      int n_rows, int n_cols, bool vec, float (&v)[8]) {
  if (vec && r < n_rows && col + 8 <= n_cols) {
    const uint4 w = *reinterpret_cast<const uint4*>(src + r * ss + col);
    const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[2 * e] = __uint_as_float(ws[e] << 16);
      v[2 * e + 1] = __uint_as_float(ws[e] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      v[e] = (r < n_rows && col + e < n_cols) ? __bfloat162float(src[r * ss + col + e]) : 0.f;
  }
}

// Warp 0: the inclusive cumsum of a over the chunk's kChunk positions
// (zero past n_rows), four positions a lane, into acum.
__device__ __forceinline__ void chunk_cumsum(const float* __restrict__ a, long long ss, int n_rows,
                                             float* acum, int lane) {
  float v[4], run = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int r = 4 * lane + k;
    run += r < n_rows ? a[r * ss] : 0.f;
    v[k] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float up = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += up;
  }
  float before = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) before = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) acum[4 * lane + k] = before + v[k];
}

// Shared memory of pass 1 for a padded state dim NP (64 or 128): the B
// tile (kChunk x NP), x * decay as hi and lo tiles (kChunk x kPT each),
// then a_cum.  The base is 1024-byte aligned (the kernels declare no
// static shared memory).
template <int NP>
struct StateSmem {
  static constexpr int kB = kChunk * NP * 2;
  static constexpr int kX = kChunk * kPT * 2;
  static constexpr int kBytes = kB + 2 * kX + kChunk * 4;
};

// Pass 1: S_c = x^T . (B * exp(a_cum[-1] - a_cum)) for one (chunk, p tile,
// head, batch), computed as (x * decay)^T . B: A is x * decay (MN-major: p
// contiguous) split into hi and lo, B the B tile (MN-major: n contiguous).
// Warpgroup w takes the state's columns [64w, 64w + 64).
template <int NP>
__global__ void __launch_bounds__(kThreads)
chunk_state_kernel(const bf16* __restrict__ x, const float* __restrict__ a,
                   const bf16* __restrict__ Bm, float* __restrict__ ws, float* __restrict__ decay,
                   int L, int H, int P, int N, int n_chunks, int n_ptiles, Strides sx, Strides sa,
                   Strides sb) {
  using S = StateSmem<NP>;
  extern __shared__ __align__(1024) uint8_t smem_tc[];
  const uint32_t Bs = smem_u32(smem_tc);
  if (Bs & (kAtomBytes - 1)) __trap();  // the swizzled tiles need 1024-byte alignment
  const uint32_t XH = Bs + S::kB, XL = XH + S::kX;
  float* acum = reinterpret_cast<float*>(smem_tc + S::kB + 2 * S::kX);

  const int c = blockIdx.x / n_ptiles, pt = blockIdx.x % n_ptiles;
  const int h = blockIdx.y, b = blockIdx.z;
  const int t0 = c * kChunk, p0 = pt * kPT;
  const int rows = min(kChunk, L - t0), pcols = min(kPT, P - p0);
  // the warp index through a shuffle, so the compiler sees it is uniform
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0), lane = threadIdx.x & 31;

  // every global load is issued before the first wait: the B tile's
  // copies, this thread's x units (into registers) and a
  const bf16* bh = Bm + sb.at(b, h) + t0 * sb.s;
  load_tile<kChunk, NP>(Bs, bh, sb.s, rows, N, rows_aligned16(bh, sb.s, 2));
  constexpr int kXUnits = kChunk * kPT / 8 / kThreads;  // 8 values of a row each
  const bf16* xh = x + b * sx.b + h * sx.h + t0 * sx.s + p0;
  const bool xvec = rows_aligned16(xh, sx.s, 2);
  float v[kXUnits][8];
#pragma unroll
  for (int k = 0; k < kXUnits; ++k) {
    const int u = threadIdx.x + k * kThreads;
    load8(xh, sx.s, u / (kPT / 8), (u % (kPT / 8)) * 8, rows, pcols, xvec, v[k]);
  }
  if (warp == 0) chunk_cumsum(a + b * sa.b + h * sa.h + t0 * sa.s, sa.s, rows, acum, lane);
  __syncthreads();

  // x * exp(a_cum[-1] - a_cum) in fp32, split into bf16 hi and lo tiles
  const float last = acum[kChunk - 1];
#pragma unroll
  for (int k = 0; k < kXUnits; ++k) {
    const int u = threadIdx.x + k * kThreads;
    const int r = u / (kPT / 8), col = (u % (kPT / 8)) * 8;
    const float dec = expf(last - acum[r]);
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      split_pair(v[k][2 * e] * dec, v[k][2 * e + 1] * dec, hi[e], lo[e]);
    st_shared_v4(XH + swizzle_off(r, col, kChunk), hi);
    st_shared_v4(XL + swizzle_off(r, col, kChunk), lo);
  }
  tiles_written();
  __syncthreads();

  const int wg = warp >> 2;
  if (wg < NP / 64) {
    float acc[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[j] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk) {  // 16 positions: two 8-row atoms
      const uint64_t desc_b = make_desc(Bs + wg * (kChunk * kRowBytes) + kk * 2 * kAtomBytes);
      wgmma_ss<1, 1>(acc, make_desc(XH + kk * 2 * kAtomBytes), desc_b, 1);
      wgmma_ss<1, 1>(acc, make_desc(XL + kk * 2 * kAtomBytes), desc_b, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    float* out = ws + (((long long)b * H + h) * n_chunks + c) * ((long long)P * N);
    const int row0 = p0 + 16 * (warp & 3) + (lane >> 2);
#pragma unroll
    for (int j = 0; j < 32; j += 2) {  // values j, j + 1: columns n, n + 1 of row p
      const int p = row0 + 8 * ((j >> 1) & 1);
      const int n = 64 * wg + 8 * (j >> 2) + 2 * (lane & 3);
      if (p >= P || n >= N) continue;
      float* dst = out + (long long)p * N + n;
      if (n + 1 < N && (N & 1) == 0) {
        *reinterpret_cast<float2*>(dst) = make_float2(acc[j], acc[j + 1]);
      } else {
        dst[0] = acc[j];
        if (n + 1 < N) dst[1] = acc[j + 1];
      }
    }
  }
  if (pt == 0 && threadIdx.x == 0)
    decay[((long long)b * H + h) * n_chunks + c] = expf(last);
}

// Pass 2: for each (batch, head) and each of the p * n state elements, in
// the plain version's loop order: entering[c] = s; s = decay[c] * s + S_c
// (one rounding per operation, as the plain version takes them).  entering
// overwrites S_c; the final s goes to state when it is not null.
__global__ void __launch_bounds__(kPassThreads)
state_pass_kernel(float* __restrict__ ws, const float* __restrict__ decay,
                  float* __restrict__ state, int n_chunks, long long PN, int blocks_per_head) {
  const long long bh = blockIdx.x / blocks_per_head;
  const long long e = (long long)(blockIdx.x % blocks_per_head) * kPassThreads + threadIdx.x;
  if (e >= PN) return;
  float* w = ws + bh * n_chunks * PN + e;
  const float* d = decay + bh * n_chunks;
  constexpr int kU = 8;  // loads in flight a thread
  float s = 0.f;
  for (int c0 = 0; c0 < n_chunks; c0 += kU) {
    float v[kU];
#pragma unroll
    for (int k = 0; k < kU; ++k)
      if (c0 + k < n_chunks) v[k] = w[(c0 + k) * PN];
#pragma unroll
    for (int k = 0; k < kU; ++k)
      if (c0 + k < n_chunks) {
        w[(c0 + k) * PN] = s;
        s = __fadd_rn(__fmul_rn(s, d[c0 + k]), v[k]);
      }
  }
  if (state != nullptr) state[bh * PN + e] = s;
}

// Shared memory of pass 3: the C and B tiles (kChunk x NP each), the x tile
// (kChunk x kPT), the entering state's rows of this p tile as hi and lo
// tiles (kPT x NP each), then a_cum: 115,200 bytes at NP 128, so two blocks
// fit an SM.
template <int NP>
struct OutSmem {
  static constexpr int kCB = kChunk * NP * 2;
  static constexpr int kX = kChunk * kPT * 2;
  static constexpr int kE = kPT * NP * 2;
  static constexpr int kBytes = 2 * kCB + kX + 2 * kE + kChunk * 4;
};

// Pass 3: y for one (chunk, p tile, head, batch).  Warpgroup w takes the
// chunk's rows [64w, 64w + 64): y = exp(a_cum) * (C . entering^T) (C and
// the entering state K-major, n contiguous), then for each 64-column tile
// jt <= w of the scores, s = C . B^T (both K-major), s *= L in fp32, s split
// into hi and lo in registers (the accumulator's layout is the A
// operand's), y += s . x (x MN-major: p contiguous).  y is rounded to bf16
// once.
template <int NP>
__global__ void __launch_bounds__(kThreads, 2)
chunk_output_kernel(const bf16* __restrict__ x, const float* __restrict__ a,
                    const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
                    const float* __restrict__ ws, bf16* __restrict__ y, int L, int H, int P, int N,
                    int n_chunks, int n_ptiles, Strides sx, Strides sa, Strides sb, Strides sc) {
  using S = OutSmem<NP>;
  extern __shared__ __align__(1024) uint8_t smem_tc[];
  const uint32_t Cs = smem_u32(smem_tc);
  if (Cs & (kAtomBytes - 1)) __trap();  // the swizzled tiles need 1024-byte alignment
  const uint32_t Bs = Cs + S::kCB, Xs = Bs + S::kCB, EH = Xs + S::kX, EL = EH + S::kE;
  float* acum = reinterpret_cast<float*>(smem_tc + 2 * S::kCB + S::kX + 2 * S::kE);

  const int c = blockIdx.x / n_ptiles, pt = blockIdx.x % n_ptiles;
  const int h = blockIdx.y, b = blockIdx.z;
  const int t0 = c * kChunk, p0 = pt * kPT;
  const int rows = min(kChunk, L - t0), pcols = min(kPT, P - p0);
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0), lane = threadIdx.x & 31;

  const bf16* ch = Cm + sc.at(b, h) + t0 * sc.s;
  const bf16* bh = Bm + sb.at(b, h) + t0 * sb.s;
  const bf16* xh = x + b * sx.b + h * sx.h + t0 * sx.s + p0;
  load_tile<kChunk, NP>(Cs, ch, sc.s, rows, N, rows_aligned16(ch, sc.s, 2));
  load_tile<kChunk, NP>(Bs, bh, sb.s, rows, N, rows_aligned16(bh, sb.s, 2));
  load_tile<kChunk, kPT>(Xs, xh, sx.s, rows, pcols, rows_aligned16(xh, sx.s, 2));
  // the state entering the chunk, rows p0.. of it: every load in flight
  // before the first use (16-byte loads when n is a multiple of 4, which
  // keeps every row 16-byte aligned), then split into hi and lo
  constexpr int kEUnits = kPT * NP / 8 / kThreads;  // 8 values of a row each
  const float* ent = ws + (((long long)b * H + h) * n_chunks + c) * ((long long)P * N);
  float v[kEUnits][8];
#pragma unroll
  for (int k = 0; k < kEUnits; ++k) {
    const int u = threadIdx.x + k * kThreads;
    const int p = p0 + u / (NP / 8), col = (u % (NP / 8)) * 8;
    const float* row = ent + (long long)p * N + col;
    if (p < P && col + 8 <= N && (N & 3) == 0) {
      const float4 lo4 = *reinterpret_cast<const float4*>(row);
      const float4 hi4 = *reinterpret_cast<const float4*>(row + 4);
      v[k][0] = lo4.x, v[k][1] = lo4.y, v[k][2] = lo4.z, v[k][3] = lo4.w;
      v[k][4] = hi4.x, v[k][5] = hi4.y, v[k][6] = hi4.z, v[k][7] = hi4.w;
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[k][e] = (p < P && col + e < N) ? row[e] : 0.f;
    }
  }
  if (warp == 0) chunk_cumsum(a + b * sa.b + h * sa.h + t0 * sa.s, sa.s, rows, acum, lane);
#pragma unroll
  for (int k = 0; k < kEUnits; ++k) {
    const int u = threadIdx.x + k * kThreads;
    const int r = u / (NP / 8), col = (u % (NP / 8)) * 8;
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split_pair(v[k][2 * e], v[k][2 * e + 1], hi[e], lo[e]);
    st_shared_v4(EH + swizzle_off(r, col, kPT), hi);
    st_shared_v4(EL + swizzle_off(r, col, kPT), lo);
  }
  tiles_written();
  __syncthreads();

  const int wg = warp >> 2;
  const uint32_t Cw = Cs + wg * 64 * kRowBytes;  // this warpgroup's 64 rows of C
  const int r0 = 64 * wg + 16 * (warp & 3) + (lane >> 2);  // its rows r0 and r0 + 8
  float yacc[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) yacc[j] = 0.f;
  float s[32];  // a 64 x 64 score tile of this warpgroup's rows
#pragma unroll
  for (int j = 0; j < 32; ++j) s[j] = 0.f;
  const auto issue_scores = [&](int jt) {  // s = C . B^T, score columns [64jt, 64jt + 64)
#pragma unroll
    for (int kk = 0; kk < NP / 16; ++kk) {
      const uint32_t k_off = (kk >> 2) * (kChunk * kRowBytes) + (kk & 3) * 32;
      wgmma_ss(s, make_desc(Cw + k_off), make_desc(Bs + jt * 64 * kRowBytes + k_off), kk > 0);
    }
  };
  // one group: y = C . entering^T and the first score tile
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < NP / 16; ++kk) {
    const uint64_t desc_c = make_desc(Cw + (kk >> 2) * (kChunk * kRowBytes) + (kk & 3) * 32);
    const uint32_t e_off = (kk >> 2) * (kPT * kRowBytes) + (kk & 3) * 32;
    wgmma_ss(yacc, desc_c, make_desc(EH + e_off), 1);
    wgmma_ss(yacc, desc_c, make_desc(EL + e_off), 1);
  }
  issue_scores(0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(yacc);
  fence_regs(s);
  // y times exp(a_cum), row by row
  const float ai[2] = {acum[r0], acum[r0 + 8]};
  const float ea[2] = {expf(ai[0]), expf(ai[1])};
#pragma unroll
  for (int j = 0; j < 32; ++j) yacc[j] *= ea[(j >> 1) & 1];

  // y += ((C . B^T) * L) . x over the score tiles at or left of the
  // diagonal; tile jt's product runs in one group with tile jt + 1's scores
  for (int jt = 0; jt <= wg; ++jt) {
    uint32_t ph[4][4], pl[4][4];
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int rl = (j >> 1) & 1, col = 64 * jt + 8 * (j >> 2) + 2 * (lane & 3) + (j & 1);
      s[j] = col <= r0 + 8 * rl ? s[j] * ex2_approx((ai[rl] - acum[col]) * kLog2e) : 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        split_pair(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1], ph[kk][i], pl[kk][i]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // score columns 16kk..16kk+15: x rows, two 8-row atoms
      const uint64_t desc_x = make_desc(Xs + jt * 8 * kAtomBytes + kk * 2 * kAtomBytes);
      wgmma_rs(yacc, ph[kk], desc_x);
      wgmma_rs(yacc, pl[kk], desc_x);
    }
    if (jt < wg) issue_scores(jt + 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(yacc);
    fence_regs(s);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      fence_regs(ph[kk]);
      fence_regs(pl[kk]);
    }
  }

  bf16* yb = y + (((long long)b * L + t0) * H + h) * P + p0;
  const long long ys = (long long)H * P;
#pragma unroll
  for (int j = 0; j < 32; j += 2) {
    const int r = r0 + 8 * ((j >> 1) & 1), col = 8 * (j >> 2) + 2 * (lane & 3);
    if (r >= rows || col >= pcols) continue;
    bf16* dst = yb + r * ys + col;
    if (col + 1 < pcols && (P & 1) == 0) {
      *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(yacc[j], yacc[j + 1]);
    } else {
      dst[0] = __float2bfloat16_rn(yacc[j]);
      if (col + 1 < pcols) dst[1] = __float2bfloat16_rn(yacc[j + 1]);
    }
  }
}

template <int NP>
cudaError_t launch(const void* x, const float* a, const void* Bm, const void* Cm, void* y,
                   float* state, float* work, int Bsz, int L, int H, int P, int N, Strides sx,
                   Strides sa, Strides sb, Strides sc, cudaStream_t stream) {
  const int n_chunks = (L + kChunk - 1) / kChunk, n_ptiles = (P + kPT - 1) / kPT;
  const long long PN = (long long)P * N;
  float* ws = work;
  float* decay = work + (long long)Bsz * H * n_chunks * PN;
  const auto bx = static_cast<const bf16*>(x);
  const auto bB = static_cast<const bf16*>(Bm);
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(chunk_state_kernel<NP>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  StateSmem<NP>::kBytes)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(chunk_output_kernel<NP>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  OutSmem<NP>::kBytes)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(chunk_output_kernel<NP>,
                                  cudaFuncAttributePreferredSharedMemoryCarveout,
                                  cudaSharedmemCarveoutMaxShared)) != cudaSuccess)
    return err;
  const dim3 grid(n_chunks * n_ptiles, H, Bsz);
  chunk_state_kernel<NP><<<grid, kThreads, StateSmem<NP>::kBytes, stream>>>(
      bx, a, bB, ws, decay, L, H, P, N, n_chunks, n_ptiles, sx, sa, sb);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int per_head = (int)((PN + kPassThreads - 1) / kPassThreads);
  state_pass_kernel<<<per_head * Bsz * H, kPassThreads, 0, stream>>>(ws, decay, state, n_chunks,
                                                                     PN, per_head);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  chunk_output_kernel<NP><<<grid, kThreads, OutSmem<NP>::kBytes, stream>>>(
      bx, a, bB, static_cast<const bf16*>(Cm), ws, static_cast<bf16*>(y), L, H, P, N, n_chunks,
      n_ptiles, sx, sa, sb, sc);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

extern "C" {

const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Positions of the bf16 path's chunk.
int ssd_scan_chunk() { return tc::kChunk; }

// y (b, l, h, p) contiguous = the SSD scan of x (b, l, h, p), a (b, l, h)
// fp32 and B, C (b, l, h / heads_per_group, n), each given by element
// strides (batch, time, head or group) with a unit stride in its last dim
// (head i reads B and C's row i / heads_per_group); x, B, C and y share dtype (0
// fp32, 1 bf16).  When state is not null it receives the fp32 (b, h, p, n)
// state after position l - 1, contiguous.  For bf16, work holds
// b * h * ceil(l / ssd_scan_chunk()) * (p * n + 1) fp32 values: the chunk
// states, then the chunks' decays (fp32 inputs need no workspace).
int ssd_scan_launch(const void* x, const void* a, const void* Bm, const void* Cm, void* y,
                    void* state, void* work, int Bsz, int L, int H, int P, int N, long long x_sb,
                    long long x_ss, long long x_sh, long long a_sb, long long a_ss,
                    long long a_sh, long long b_sb, long long b_ss, long long b_sh,
                    long long c_sb, long long c_ss, long long c_sh, int heads_per_group,
                    int dtype, int device, void* stream) {
  if (Bsz < 1 || L < 1 || H < 1 || P < 1 || N < 1 || N > kMaxState || H > 65535 || Bsz > 65535 ||
      heads_per_group < 1 || H % heads_per_group)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Strides sx{x_sb, x_ss, x_sh}, sa{a_sb, a_ss, a_sh},
      sb{b_sb, b_ss, b_sh, heads_per_group}, sc{c_sb, c_ss, c_sh, heads_per_group};
  const float* af = static_cast<const float*>(a);
  float* sf = static_cast<float*>(state);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) {
    err = dispatch<float>(x, af, Bm, Cm, y, sf, Bsz, L, H, P, N, sx, sa, sb, sc, s);
  } else if (dtype == kBF16) {
    if (work == nullptr) return (int)cudaErrorInvalidValue;
    float* wf = static_cast<float*>(work);
    err = N <= 64 ? tc::launch<64>(x, af, Bm, Cm, y, sf, wf, Bsz, L, H, P, N, sx, sa, sb, sc, s)
                  : tc::launch<128>(x, af, Bm, Cm, y, sf, wf, Bsz, L, H, P, N, sx, sa, sb, sc, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}

}  // extern "C"

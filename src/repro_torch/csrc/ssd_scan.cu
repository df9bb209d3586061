// Hand-written Hopper (sm_90a) kernels for the Mamba2 SSD chunked scan
// (state-space duality): its forward and its backward.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/ssd_scan.py:
//   chunk_state_kernel, state_pass_kernel,  <- _ssd_kernel (ssd_scan.py:24),
//   chunk_output_kernel (bf16 inputs);         pallas_call :84
//   ssd_kernel (fp32 inputs)
// and adds the backward, which the JAX package leaves to jax.grad of its
// chunked jnp oracle (models/ssm.py ssd_chunked):
//   scan_bwd_sums, scan_bwd_pass, scan_bwd_dc, scan_bwd_dxdb
// (the forward's kernel names are not reused: the benchmark's readers time
// the forward by them).
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
// Backward (ssd_scan_backward, bf16 and fp32 inputs alike): the
// vector-Jacobian product for the cotangent gy of y and gstate of the final
// state (Mamba2 paper, arXiv:2405.21060 sections 6-7, in chunks of kChunk),
// in four passes:
//   1. scan_bwd_sums, grid (chunk, head, 2 x batch): each chunk's own state
//      S_c (as chunk_state_kernel) and decay, and the state cotangent its
//      outputs give, Gamma_c = (gy * exp(a_cum))^T . C;
//   2. scan_bwd_pass, one thread per (batch, head, p*n element): the
//      entering states in the forward's order, then back from gstate the
//      cotangent G_c of the state chunk c hands on (G = decay * G + Gamma);
//   3. scan_bwd_dc, grid (chunk, group, batch): dC_i = exp(a_cum_i) gy_i .
//      entering + sum_j<=i (gy_i . x_j) L_ij B_j, and each row's a_cum
//      cotangent from the scores (sum_j<i of (gy_i . x_j)(C_i . B_j) L_ij)
//      and from exp(a_cum_i) (C_i . that state term);
//   4. scan_bwd_dxdb, grid (chunk, group, batch): dx_j = d_j B_j . G^T +
//      sum_i>=j (C_i . B_j) L_ij gy_i and dB_j = d_j x_j . G + sum_i>=j
//      (gy_i . x_j) L_ij C_i (d_j = exp(a_cum[-1] - a_cum_j)), the columns'
//      a_cum cotangents and the chunk decay's at the last position, and da
//      as their reverse cumulative sum over the chunk.
// Passes 3 and 4 take the heads of a group of B and C one after another,
// so grouped dB and dC are summed over the group in fp32 registers and
// rounded once; a head-broadcast view's grads are per head (autograd sums
// them through the view).  Every product is wgmma, the score tiles as the
// forward's (C . B^T and gy . x^T, and their transposes for rows j,
// recomputed rather than stored); fp32 inputs are split into bf16 hi and
// lo tiles on load, and every fp32 operand (the decayed scores, x or gy
// times a decay, the entering states, G) is split as in the forward, lo x
// lo products left out: each such operand keeps about 16 significant bits
// (a residual of at most 2^-16 of it).  For bf16 inputs (x, B, C and gy
// exact operands) that is far under the one rounding to bf16: the result
// is the fp32 VJP rounded once.  fp32 inputs enter the products with 16
// significant bits where fp32 has 24: their grads err by about 1e-5 of
// max |grad| (the plain fp32 VJP's by about 1e-7), fp32 storage but not
// the fp32 VJP.  L uses ex2.approx as the forward's does.  No
// atomics: every sum has a fixed order (quad shuffles, one warp's scan),
// so the same inputs give the same bits.  p is at most 64 (one tile).
// What bounds it: latency.  At mamba2-130m's training shape (8, 4096, 24,
// 64, 128) the function's least bytes (x, gy, a, B and C read, dx, da, dB
// and dC written, B's and C's at their one group) are 342 MB, 0.102 ms at
// 3.35 TB/s, and its products 168 GFLOP (6qn + 4qp + 10pn a token and
// head), 0.169 ms at the bf16 peak, which bounds it; the passes also write
// and read the workspace (b * h * c * (2 * p * n + 129) fp32, 406 MB
// there), recompute the score tiles and the lo halves, and for a
// head-broadcast view write dB and dC per head (386 MB more there, which
// autograd reads back to sum).  Passes 3 and 4 take 206 and 255 registers a thread and
// 133 KB of tiles at bf16 and n 128: one block an SM, whose loads and
// dependent products run one after another.
//
// Interface: plain C, bound with ctypes.  The entry points set the device,
// launch on the caller's stream, do not synchronise, allocate nothing
// (workspaces come from the caller) and return cudaGetLastError().
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

// ============================================ bf16 and fp32: the backward
// The vector-Jacobian product of the scan (header, "Backward"): four passes
// on the tensor cores, every product over the operands' bf16 parts.

// Operand parts of an input dtype: bf16 values are exact wgmma operands (one
// part); fp32 values are split into a bf16 hi and lo tile (two parts).
template <typename T> struct In;
template <> struct In<bf16> { static constexpr int kParts = 1; };
template <> struct In<float> { static constexpr int kParts = 2; };

// Eight fp32 values of a row (zero past n_rows / n_cols), 16-byte loads
// where vec.
__device__ __forceinline__ void load8(const float* __restrict__ src, long long ss, int r, int col,
                                      int n_rows, int n_cols, bool vec, float (&v)[8]) {
  if (vec && r < n_rows && col + 8 <= n_cols) {
    const float4 lo4 = *reinterpret_cast<const float4*>(src + r * ss + col);
    const float4 hi4 = *reinterpret_cast<const float4*>(src + r * ss + col + 4);
    v[0] = lo4.x, v[1] = lo4.y, v[2] = lo4.z, v[3] = lo4.w;
    v[4] = hi4.x, v[5] = hi4.y, v[6] = hi4.z, v[7] = hi4.w;
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      v[e] = (r < n_rows && col + e < n_cols) ? src[r * ss + col + e] : 0.f;
  }
}

// Rows [0, R) x columns [0, W) of an input matrix (row r at src + r * ss)
// into its swizzled parts, `part` bytes apart: bf16 rows as they are, fp32
// rows split into hi and lo; zero past n_rows and n_cols.  The caller waits
// with tiles_written and a barrier.
template <int R, int W>
__device__ __forceinline__ void load_in(uint32_t dst, int, const bf16* __restrict__ src,
                                        long long ss, int n_rows, int n_cols) {
  load_tile<R, W>(dst, src, ss, n_rows, n_cols, rows_aligned16(src, ss, 2));
}
template <int R, int W>
__device__ __forceinline__ void load_in(uint32_t dst, int part, const float* __restrict__ src,
                                        long long ss, int n_rows, int n_cols) {
  constexpr int kUnits = W / 8;
  const bool vec = rows_aligned16(src, ss, 4);
  for (int u = threadIdx.x; u < R * kUnits; u += kThreads) {
    const int r = u / kUnits, col = (u % kUnits) * 8;
    float v[8];
    load8(src, ss, r, col, n_rows, n_cols, vec, v);
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split_pair(v[2 * e], v[2 * e + 1], hi[e], lo[e]);
    const uint32_t off = swizzle_off(r, col, R);
    st_shared_v4(dst + off, hi);
    st_shared_v4(dst + part + off, lo);
  }
}

// The fp32 value (r, col) of a tile of R rows stored in P parts `part` bytes
// apart.
template <int P>
__device__ __forceinline__ float tile_at(const uint8_t* base, int part, int r, int col, int R) {
  const uint32_t off = swizzle_off(r, col, R);
  float v = __bfloat162float(*reinterpret_cast<const bf16*>(base + off));
  if (P == 2) v += __bfloat162float(*reinterpret_cast<const bf16*>(base + part + off));
  return v;
}

// acc += A . B over the operands' parts (PA, PB: 1 or 2, the lo tile `part`
// bytes after the hi one), the lo x lo product left out: its size is at most
// 2^-16 of the product's, below the splits' own residual.
template <int PA, int PB, int kTA, int kTB>
__device__ __forceinline__ void mma_ss(float (&acc)[32], uint32_t a, int a_part, uint32_t b,
                                       int b_part) {
  wgmma_ss<kTA, kTB>(acc, make_desc(a), make_desc(b), 1);
  if (PB == 2) wgmma_ss<kTA, kTB>(acc, make_desc(a), make_desc(b + b_part), 1);
  if (PA == 2) wgmma_ss<kTA, kTB>(acc, make_desc(a + a_part), make_desc(b), 1);
}
// acc += (hi + lo) . B: A in registers, B (MN-major) over its PB parts.
template <int PB>
__device__ __forceinline__ void mma_rs(float (&acc)[32], const uint32_t (&hi)[4],
                                       const uint32_t (&lo)[4], uint32_t b, int b_part) {
  wgmma_rs(acc, hi, make_desc(b));
  wgmma_rs(acc, lo, make_desc(b));
  if (PB == 2) wgmma_rs(acc, hi, make_desc(b + b_part));
}
// A 64 x 64 accumulator tile as the A operand of four 64 x 16 products,
// each value split into hi and lo.
__device__ __forceinline__ void split_tile(const float (&s)[32], uint32_t (&hi)[4][4],
                                           uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      split_pair(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1], hi[kk][i], lo[kk][i]);
}
template <int N>
__device__ __forceinline__ void zero(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = 0.f;
}
// Sum over the four lanes that hold one accumulator row.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Shared memory of the sums pass: the V tile's parts (kChunk x NP each), U
// times its weight as hi and lo tiles (kChunk x kPT each), then a_cum.
template <typename T, int NP>
struct SumsSmem {
  static constexpr int kParts = In<T>::kParts;
  static constexpr int kV = kChunk * NP * 2;
  static constexpr int kU = kChunk * kPT * 2;
  static constexpr int kBytes = kParts * kV + 2 * kU + kChunk * 4;
};

// Backward pass 1, grid (chunk, head, 2 x batch): for even z, the chunk's
// own state S_c = (x * exp(a_cum[-1] - a_cum))^T . B, as chunk_state_kernel
// computes it, and the chunk's decay exp(a_cum[-1]); for odd z, the state
// gradient the chunk's outputs give, Gamma_c = (gy * exp(a_cum))^T . C.
// Both (b, h, c, p, n) fp32.  Warpgroup w takes columns [64w, 64w + 64).
template <typename T, int NP>
__global__ void __launch_bounds__(kThreads)
scan_bwd_sums(const T* __restrict__ x, const T* __restrict__ gy, const float* __restrict__ a,
              const T* __restrict__ Bm, const T* __restrict__ Cm, float* __restrict__ ws_s,
              float* __restrict__ ws_g, float* __restrict__ decay, int L, int H, int P, int N,
              int n_chunks, Strides sx, Strides sg, Strides sa, Strides sb, Strides sc) {
  using S = SumsSmem<T, NP>;
  extern __shared__ __align__(1024) uint8_t smem_tc[];
  const uint32_t Vs = smem_u32(smem_tc);
  if (Vs & (kAtomBytes - 1)) __trap();  // the swizzled tiles need 1024-byte alignment
  const uint32_t UH = Vs + S::kParts * S::kV, UL = UH + S::kU;
  float* acum = reinterpret_cast<float*>(smem_tc + S::kParts * S::kV + 2 * S::kU);

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z >> 1;
  const bool grad = blockIdx.z & 1;
  const int t0 = c * kChunk, rows = min(kChunk, L - t0);
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0), lane = threadIdx.x & 31;

  const Strides& sv = grad ? sc : sb;
  load_in<kChunk, NP>(Vs, S::kV, (grad ? Cm : Bm) + sv.at(b, h) + t0 * sv.s, sv.s, rows, N);
  const Strides& su = grad ? sg : sx;
  const T* u = (grad ? gy : x) + b * su.b + h * su.h + t0 * su.s;
  const bool uvec = rows_aligned16(u, su.s, sizeof(T));
  constexpr int kUnits = kChunk * kPT / 8 / kThreads;  // 8 values of a row each
  float v[kUnits][8];
#pragma unroll
  for (int k = 0; k < kUnits; ++k) {
    const int unit = threadIdx.x + k * kThreads;
    load8(u, su.s, unit / (kPT / 8), (unit % (kPT / 8)) * 8, rows, P, uvec, v[k]);
  }
  if (warp == 0) chunk_cumsum(a + b * sa.b + h * sa.h + t0 * sa.s, sa.s, rows, acum, lane);
  __syncthreads();

  const float last = acum[kChunk - 1];
#pragma unroll
  for (int k = 0; k < kUnits; ++k) {
    const int unit = threadIdx.x + k * kThreads;
    const int r = unit / (kPT / 8), col = (unit % (kPT / 8)) * 8;
    const float w = grad ? expf(acum[r]) : expf(last - acum[r]);
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split_pair(v[k][2 * e] * w, v[k][2 * e + 1] * w, hi[e], lo[e]);
    st_shared_v4(UH + swizzle_off(r, col, kChunk), hi);
    st_shared_v4(UL + swizzle_off(r, col, kChunk), lo);
  }
  tiles_written();
  __syncthreads();

  const int wg = warp >> 2;
  if (wg < NP / 64) {
    float acc[32];
    zero(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk)  // 16 positions: two 8-row atoms
      mma_ss<2, S::kParts, 1, 1>(acc, UH + kk * 2 * kAtomBytes, S::kU,
                                 Vs + wg * (kChunk * kRowBytes) + kk * 2 * kAtomBytes, S::kV);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    float* out = (grad ? ws_g : ws_s) + (((long long)b * H + h) * n_chunks + c) * ((long long)P * N);
    const int row0 = 16 * (warp & 3) + (lane >> 2);
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
  if (!grad && threadIdx.x == 0) decay[((long long)b * H + h) * n_chunks + c] = expf(last);
}

// Backward pass 2, one thread per (batch, head, p*n element): the forward's
// state pass (entering[c] = s; s = decay[c] * s + S_c, entering overwriting
// S_c), then the reverse one from the final state's cotangent (zero when
// gstate is null): G[c] = g; g = decay[c] * g + Gamma_c, G (the cotangent
// of the state chunk c hands on) overwriting Gamma_c.  One rounding per
// operation, in the plain version's (and its autograd's) order.
__global__ void __launch_bounds__(kPassThreads)
scan_bwd_pass(float* __restrict__ ws_s, float* __restrict__ ws_g, const float* __restrict__ decay,
              const float* __restrict__ gstate, int n_chunks, long long PN, int blocks_per_head) {
  const long long bh = blockIdx.x / blocks_per_head;
  const long long e = (long long)(blockIdx.x % blocks_per_head) * kPassThreads + threadIdx.x;
  if (e >= PN) return;
  float* w = ws_s + bh * n_chunks * PN + e;
  float* gw = ws_g + bh * n_chunks * PN + e;
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
  float g = gstate != nullptr ? gstate[bh * PN + e] : 0.f;
  for (int c0 = n_chunks - 1; c0 >= 0; c0 -= kU) {
    float v[kU];
#pragma unroll
    for (int k = 0; k < kU; ++k)
      if (c0 - k >= 0) v[k] = gw[(c0 - k) * PN];
#pragma unroll
    for (int k = 0; k < kU; ++k)
      if (c0 - k >= 0) {
        gw[(c0 - k) * PN] = g;
        g = __fadd_rn(__fmul_rn(g, d[c0 - k]), v[k]);
      }
  }
}

// Row pitch (elements) of a staged tile of `cols` columns of T: 16 bytes
// of padding, so that the eight rows a warp writes at once fall on
// different banks and every row stays 16-byte aligned.
template <typename T>
__host__ __device__ constexpr int stage_pitch(int cols) {
  return cols + 16 / (int)sizeof(T);
}

// Shared memory of backward passes 3 and 4: the C and B tiles' parts
// (kChunk x NP each), the x and gy tiles' parts (kChunk x kPT each), a state
// (kPT x NP) as hi and lo tiles, then a_cum, two rows of kChunk floats and
// 32 for reductions: 133,120 bytes at bf16 and NP 128, 231,040 at fp32.
template <typename T, int NP>
struct ChunkSmem {
  static constexpr int kParts = In<T>::kParts;
  static constexpr int kCB = kChunk * NP * 2;
  static constexpr int kX = kChunk * kPT * 2;
  static constexpr int kE = kPT * NP * 2;
  static constexpr int kTiles = kParts * (2 * kCB + 2 * kX) + 2 * kE;
  static constexpr int kBytes = kTiles + (3 * kChunk + 32) * 4;
  // dB and dC are staged in C and B's space, dx in x and gy's
  static_assert(kChunk * stage_pitch<T>(NP) * (int)sizeof(T) <= 2 * kParts * kCB &&
                    kChunk * stage_pitch<T>(kPT) * (int)sizeof(T) <= 2 * kParts * kX,
                "a staged tile outgrows the space it reuses");
};

// The (P, N) fp32 state at src into hi and lo tiles (kPT x NP, zero past P
// and N); with `with` not null, dot += the sum of its products with the
// same elements of `with`.
template <int NP>
__device__ __forceinline__ void load_state(uint32_t EH, uint32_t EL, const float* __restrict__ src,
                                           const float* __restrict__ with, int P, int N,
                                           float& dot) {
  constexpr int kUnits = kPT * NP / 8 / kThreads;  // 8 values of a row each
  const bool vec = (N & 3) == 0;
  float v[kUnits][8];
#pragma unroll
  for (int k = 0; k < kUnits; ++k) {
    const int u = threadIdx.x + k * kThreads;
    load8(src, N, u / (NP / 8), (u % (NP / 8)) * 8, P, N, vec, v[k]);
  }
  if (with != nullptr) {
#pragma unroll
    for (int k = 0; k < kUnits; ++k) {
      const int u = threadIdx.x + k * kThreads;
      float w[8];
      load8(with, N, u / (NP / 8), (u % (NP / 8)) * 8, P, N, vec, w);
#pragma unroll
      for (int e = 0; e < 8; ++e) dot = fmaf(v[k][e], w[e], dot);
    }
  }
#pragma unroll
  for (int k = 0; k < kUnits; ++k) {
    const int u = threadIdx.x + k * kThreads;
    const int r = u / (NP / 8), col = (u % (NP / 8)) * 8;
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split_pair(v[k][2 * e], v[k][2 * e + 1], hi[e], lo[e]);
    st_shared_v4(EH + swizzle_off(r, col, kPT), hi);
    st_shared_v4(EL + swizzle_off(r, col, kPT), lo);
  }
}

// This warpgroup's 64 rows of an accumulator tile, rounded to T, into
// columns [col0, col0 + 64) of a row-major staging tile of kCols columns
// in shared memory.
template <typename T, int kCols>
__device__ __forceinline__ void stage_tile(uint8_t* stage, const float (&acc)[32], int r0,
                                           int col0) {
  constexpr int kPitch = stage_pitch<T>(kCols);
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < 32; j += 2) {
    const int r = r0 + 8 * ((j >> 1) & 1), col = col0 + 8 * (j >> 2) + 2 * (lane & 3);
    T* dst = reinterpret_cast<T*>(stage) + r * kPitch + col;
    if constexpr (sizeof(T) == 2)
      *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(acc[j], acc[j + 1]);
    else
      *reinterpret_cast<float2*>(dst) = make_float2(acc[j], acc[j + 1]);
  }
}

// Rows [0, n_rows) x columns [0, n_cols) of a staging tile of `cols`
// columns to dst (row stride ld elements), by the whole block: 16-byte
// stores where every row is 16-byte aligned, else element by element.
// The caller makes the staged rows visible with a barrier first.
template <typename T, int kCols>
__device__ __forceinline__ void store_rows(T* __restrict__ dst, long long ld, const uint8_t* stage,
                                           int n_rows, int n_cols) {
  constexpr int kPitch = stage_pitch<T>(kCols), kVec = 16 / (int)sizeof(T);
  const T* src = reinterpret_cast<const T*>(stage);
  if (n_cols % kVec == 0 && ld % kVec == 0 && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    const int per_row = n_cols / kVec;
    for (int u = threadIdx.x; u < n_rows * per_row; u += kThreads) {
      const int r = u / per_row, col = (u % per_row) * kVec;
      *reinterpret_cast<uint4*>(dst + r * ld + col) =
          *reinterpret_cast<const uint4*>(src + r * kPitch + col);
    }
  } else {
    for (int i = threadIdx.x; i < n_rows * n_cols; i += kThreads) {
      const int r = i / n_cols, col = i % n_cols;
      dst[r * ld + col] = src[r * kPitch + col];
    }
  }
}

// Backward pass 3, grid (chunk, group, batch), the group's heads one after
// another: the rows i of dC and their a_cum cotangents.  Warpgroup w takes
// rows [64w, 64w + 64).  For each head:
//   dC_i += exp(a_cum_i) (gy_i . entering) + sum_j<=i (gy_i . x_j) L_ij B_j
//   row_i = sum_j<i (gy_i . x_j)(C_i . B_j) L_ij + C_i . exp(a_cum_i)(gy_i . entering)
// (the products gy . entering (K = p) and (gy . x^T) * L . B, the latter
// split into hi and lo in registers); row goes to darow (b, h, c, kChunk),
// dC, summed over the group's heads in fp32, is rounded once.
template <typename T, int NP>
__global__ void __launch_bounds__(kThreads, 1)
scan_bwd_dc(const T* __restrict__ x, const T* __restrict__ gy, const float* __restrict__ a,
            const T* __restrict__ Bm, const T* __restrict__ Cm, const float* __restrict__ ws_s,
            float* __restrict__ darow, T* __restrict__ dC, int L, int H, int P, int N,
            int n_chunks, int r, Strides sx, Strides sg, Strides sa, Strides sb, Strides sc) {
  using S = ChunkSmem<T, NP>;
  constexpr int kParts = S::kParts;
  extern __shared__ __align__(1024) uint8_t smem_tc[];
  const uint32_t Cs = smem_u32(smem_tc);
  if (Cs & (kAtomBytes - 1)) __trap();  // the swizzled tiles need 1024-byte alignment
  const uint32_t Bs = Cs + kParts * S::kCB, Xs = Bs + kParts * S::kCB, Gs = Xs + kParts * S::kX,
                 EH = Gs + kParts * S::kX, EL = EH + S::kE;
  float* acum = reinterpret_cast<float*>(smem_tc + S::kTiles);

  const int c = blockIdx.x, gi = blockIdx.y, b = blockIdx.z;
  const int t0 = c * kChunk, rows = min(kChunk, L - t0);
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0), lane = threadIdx.x & 31;
  const int wg = warp >> 2;
  const int r0 = 64 * wg + 16 * (warp & 3) + (lane >> 2);  // this thread's rows r0, r0 + 8

  load_in<kChunk, NP>(Cs, S::kCB, Cm + sc.at(b, gi * r) + t0 * sc.s, sc.s, rows, N);
  load_in<kChunk, NP>(Bs, S::kCB, Bm + sb.at(b, gi * r) + t0 * sb.s, sb.s, rows, N);
  float dc[NP / 64][32];
#pragma unroll
  for (int nt = 0; nt < NP / 64; ++nt) zero(dc[nt]);

  for (int k = 0; k < r; ++k) {
    const int h = gi * r + k;
    const long long bhc = ((long long)b * H + h) * n_chunks + c;
    __syncthreads();  // the last head's tiles are read
    load_in<kChunk, kPT>(Xs, S::kX, x + b * sx.b + h * sx.h + t0 * sx.s, sx.s, rows, P);
    load_in<kChunk, kPT>(Gs, S::kX, gy + b * sg.b + h * sg.h + t0 * sg.s, sg.s, rows, P);
    float unused = 0.f;
    load_state<NP>(EH, EL, ws_s + bhc * P * N, nullptr, P, N, unused);
    if (warp == 0) chunk_cumsum(a + b * sa.b + h * sa.h + t0 * sa.s, sa.s, rows, acum, lane);
    tiles_written();
    __syncthreads();

    const float ai[2] = {acum[r0], acum[r0 + 8]};
    const float ea[2] = {expf(ai[0]), expf(ai[1])};
    float row[2] = {0.f, 0.f};
    // exp(a_cum_i) (gy_i . entering), an n tile at a time (K = p)
#pragma unroll
    for (int nt = 0; nt < NP / 64; ++nt) {
      float t[32];
      zero(t);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kPT / 16; ++kk)
        mma_ss<kParts, 2, 0, 1>(t, Gs + wg * 64 * kRowBytes + kk * 32, S::kX,
                                EH + nt * (kPT * kRowBytes) + kk * 2 * kAtomBytes, S::kE);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(t);
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int rl = (j >> 1) & 1, col = 64 * nt + 8 * (j >> 2) + 2 * (lane & 3) + (j & 1);
        const float v = t[j] * ea[rl];
        row[rl] = fmaf(v, tile_at<kParts>(smem_tc, S::kCB, r0 + 8 * rl, col, kChunk), row[rl]);
        dc[nt][j] += v;
      }
    }
    // the score tiles left of and on the diagonal
    for (int jt = 0; jt <= wg; ++jt) {
      float s[32], m[32];
      zero(s);
      zero(m);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NP / 16; ++kk) {  // s = C . B^T (K = n)
        const uint32_t k_off = (kk >> 2) * (kChunk * kRowBytes) + (kk & 3) * 32;
        mma_ss<kParts, kParts, 0, 0>(s, Cs + wg * 64 * kRowBytes + k_off, S::kCB,
                                     Bs + jt * 64 * kRowBytes + k_off, S::kCB);
      }
#pragma unroll
      for (int kk = 0; kk < kPT / 16; ++kk)  // m = gy . x^T (K = p)
        mma_ss<kParts, kParts, 0, 0>(m, Gs + wg * 64 * kRowBytes + kk * 32, S::kX,
                                     Xs + jt * 64 * kRowBytes + kk * 32, S::kX);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(m);
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int rl = (j >> 1) & 1, i = r0 + 8 * rl;
        const int col = 64 * jt + 8 * (j >> 2) + 2 * (lane & 3) + (j & 1);
        const float ml = col <= i ? m[j] * ex2_approx((ai[rl] - acum[col]) * kLog2e) : 0.f;
        if (col < i) row[rl] = fmaf(ml, s[j], row[rl]);
        m[j] = ml;
      }
      uint32_t ph[4][4], pl[4][4];
      split_tile(m, ph, pl);
      wgmma_fence();
#pragma unroll
      for (int nt = 0; nt < NP / 64; ++nt)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)  // (m * L) . B, score columns 16kk..: B rows
          mma_rs<kParts>(dc[nt], ph[kk], pl[kk],
                         Bs + nt * (kChunk * kRowBytes) + jt * 8 * kAtomBytes + kk * 2 * kAtomBytes,
                         S::kCB);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int nt = 0; nt < NP / 64; ++nt) fence_regs(dc[nt]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        fence_regs(ph[kk]);
        fence_regs(pl[kk]);
      }
    }
    const float row0 = quad_sum(row[0]), row1 = quad_sum(row[1]);
    if ((lane & 3) == 0) {
      darow[bhc * kChunk + r0] = row0;
      darow[bhc * kChunk + r0 + 8] = row1;
    }
  }
  const int G = H / r;
  __syncthreads();  // every tile is read: C and B's space takes the staged dC
#pragma unroll
  for (int nt = 0; nt < NP / 64; ++nt) stage_tile<T, NP>(smem_tc, dc[nt], r0, 64 * nt);
  __syncthreads();
  store_rows<T, NP>(dC + (((long long)b * L + t0) * G + gi) * N, (long long)G * N, smem_tc, rows,
                    N);
}

// Backward pass 4, grid (chunk, group, batch), the group's heads one after
// another: the rows j of dx and dB, and da.  Warpgroup w takes rows [64w,
// 64w + 64); with d_j = exp(a_cum[-1] - a_cum_j) and G the cotangent of the
// state the chunk hands on, for each head:
//   dx_j = d_j (B_j . G^T) + sum_i>=j (C_i . B_j) L_ij gy_i
//   dB_j += d_j (x_j . G) + sum_i>=j (gy_i . x_j) L_ij C_i
//   col_j = sum_i>j (gy_i . x_j)(C_i . B_j) L_ij + x_j . d_j (B_j . G^T)
// then the a_cum cotangent row_j - col_j (row_j from pass 3), plus at the
// chunk's last position sum_j x_j . d_j (B_j . G^T) + exp(a_cum[-1])
// <G, entering>, and da its reverse cumulative sum over the chunk.  dx is
// rounded once a head, dB once after the group's heads.
template <typename T, int NP>
__global__ void __launch_bounds__(kThreads, 1)
scan_bwd_dxdb(const T* __restrict__ x, const T* __restrict__ gy, const float* __restrict__ a,
              const T* __restrict__ Bm, const T* __restrict__ Cm, const float* __restrict__ ws_s,
              const float* __restrict__ ws_g, const float* __restrict__ darow, T* __restrict__ dx,
              float* __restrict__ da, T* __restrict__ dB, int L, int H, int P, int N, int n_chunks,
              int r, Strides sx, Strides sg, Strides sa, Strides sb, Strides sc) {
  using S = ChunkSmem<T, NP>;
  constexpr int kParts = S::kParts;
  extern __shared__ __align__(1024) uint8_t smem_tc[];
  const uint32_t Cs = smem_u32(smem_tc);
  if (Cs & (kAtomBytes - 1)) __trap();  // the swizzled tiles need 1024-byte alignment
  const uint32_t Bs = Cs + kParts * S::kCB, Xs = Bs + kParts * S::kCB, Gs = Xs + kParts * S::kX,
                 EH = Gs + kParts * S::kX, EL = EH + S::kE;
  float* acum = reinterpret_cast<float*>(smem_tc + S::kTiles);
  float* dacc = acum + kChunk;  // the a_cum cotangents
  float* fbuf = dacc + kChunk;  // x_j . d_j (B_j . G^T)
  float* red = fbuf + kChunk;   // a warp's share of <G, entering>
  const uint8_t* Xp = smem_tc + 2 * kParts * S::kCB;

  const int c = blockIdx.x, gi = blockIdx.y, b = blockIdx.z;
  const int t0 = c * kChunk, rows = min(kChunk, L - t0);
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0), lane = threadIdx.x & 31;
  const int wg = warp >> 2;
  const int r0 = 64 * wg + 16 * (warp & 3) + (lane >> 2);  // this thread's rows r0, r0 + 8

  load_in<kChunk, NP>(Cs, S::kCB, Cm + sc.at(b, gi * r) + t0 * sc.s, sc.s, rows, N);
  load_in<kChunk, NP>(Bs, S::kCB, Bm + sb.at(b, gi * r) + t0 * sb.s, sb.s, rows, N);
  float db[NP / 64][32];
#pragma unroll
  for (int nt = 0; nt < NP / 64; ++nt) zero(db[nt]);

  for (int k = 0; k < r; ++k) {
    const int h = gi * r + k;
    const long long bhc = ((long long)b * H + h) * n_chunks + c;
    __syncthreads();  // the last head's tiles and rows are read
    load_in<kChunk, kPT>(Xs, S::kX, x + b * sx.b + h * sx.h + t0 * sx.s, sx.s, rows, P);
    load_in<kChunk, kPT>(Gs, S::kX, gy + b * sg.b + h * sg.h + t0 * sg.s, sg.s, rows, P);
    float dot = 0.f;
    load_state<NP>(EH, EL, ws_g + bhc * P * N, ws_s + bhc * P * N, P, N, dot);
    if (warp == 0) chunk_cumsum(a + b * sa.b + h * sa.h + t0 * sa.s, sa.s, rows, acum, lane);
    tiles_written();
    __syncthreads();

    const float aj[2] = {acum[r0], acum[r0 + 8]};
    const float last = acum[kChunk - 1];
    const float dj[2] = {expf(last - aj[0]), expf(last - aj[1])};
    float f[2] = {0.f, 0.f}, col[2] = {0.f, 0.f};
    float dxa[32];
    zero(dxa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NP / 16; ++kk) {  // B . G^T (K = n)
      mma_ss<kParts, 2, 0, 0>(
          dxa, Bs + wg * 64 * kRowBytes + (kk >> 2) * (kChunk * kRowBytes) + (kk & 3) * 32, S::kCB,
          EH + (kk >> 2) * (kPT * kRowBytes) + (kk & 3) * 32, S::kE);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dxa);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int rl = (j >> 1) & 1, p = 8 * (j >> 2) + 2 * (lane & 3) + (j & 1);
      dxa[j] *= dj[rl];
      f[rl] = fmaf(dxa[j], tile_at<kParts>(Xp, S::kX, r0 + 8 * rl, p, kChunk), f[rl]);
    }
    // d_j (x_j . G), an n tile at a time (K = p)
#pragma unroll
    for (int nt = 0; nt < NP / 64; ++nt) {
      float t[32];
      zero(t);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kPT / 16; ++kk)
        mma_ss<kParts, 2, 0, 1>(t, Xs + wg * 64 * kRowBytes + kk * 32, S::kX,
                                EH + nt * (kPT * kRowBytes) + kk * 2 * kAtomBytes, S::kE);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(t);
#pragma unroll
      for (int j = 0; j < 32; ++j) db[nt][j] = fmaf(t[j], dj[(j >> 1) & 1], db[nt][j]);
    }
    // the score tiles on and right of the diagonal (transposed: rows j)
    for (int it = wg; it < kChunk / 64; ++it) {
      float s[32], m[32];
      zero(s);
      zero(m);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NP / 16; ++kk) {  // s = B . C^T (K = n)
        const uint32_t k_off = (kk >> 2) * (kChunk * kRowBytes) + (kk & 3) * 32;
        mma_ss<kParts, kParts, 0, 0>(s, Bs + wg * 64 * kRowBytes + k_off, S::kCB,
                                     Cs + it * 64 * kRowBytes + k_off, S::kCB);
      }
#pragma unroll
      for (int kk = 0; kk < kPT / 16; ++kk)  // m = x . gy^T (K = p)
        mma_ss<kParts, kParts, 0, 0>(m, Xs + wg * 64 * kRowBytes + kk * 32, S::kX,
                                     Gs + it * 64 * kRowBytes + kk * 32, S::kX);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(m);
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int rl = (j >> 1) & 1, jr = r0 + 8 * rl;
        const int i = 64 * it + 8 * (j >> 2) + 2 * (lane & 3) + (j & 1);
        const float l = i >= jr ? ex2_approx((acum[i] - aj[rl]) * kLog2e) : 0.f;
        const float ml = m[j] * l;
        if (i > jr) col[rl] = fmaf(ml, s[j], col[rl]);
        s[j] *= l;
        m[j] = ml;
      }
      uint32_t ph[4][4], pl[4][4], qh[4][4], ql[4][4];
      split_tile(s, ph, pl);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // dx += (s * L) . gy (gy rows i)
        mma_rs<kParts>(dxa, ph[kk], pl[kk], Gs + it * 8 * kAtomBytes + kk * 2 * kAtomBytes, S::kX);
      split_tile(m, qh, ql);
      wgmma_fence();
#pragma unroll
      for (int nt = 0; nt < NP / 64; ++nt)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)  // dB += (m * L) . C (C rows i)
          mma_rs<kParts>(db[nt], qh[kk], ql[kk],
                         Cs + nt * (kChunk * kRowBytes) + it * 8 * kAtomBytes + kk * 2 * kAtomBytes,
                         S::kCB);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dxa);
#pragma unroll
      for (int nt = 0; nt < NP / 64; ++nt) fence_regs(db[nt]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        fence_regs(ph[kk]);
        fence_regs(pl[kk]);
        fence_regs(qh[kk]);
        fence_regs(ql[kk]);
      }
    }
    const float f0 = quad_sum(f[0]), f1 = quad_sum(f[1]);
    const float col0 = quad_sum(col[0]), col1 = quad_sum(col[1]);
    if ((lane & 3) == 0) {
      dacc[r0] = darow[bhc * kChunk + r0] - col0 - f0;
      dacc[r0 + 8] = darow[bhc * kChunk + r0 + 8] - col1 - f1;
      fbuf[r0] = f0;
      fbuf[r0 + 8] = f1;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
    if (lane == 0) red[warp] = dot;
    __syncthreads();  // every tile of this head is read: x and gy's space takes the staged dx
    stage_tile<T, kPT>(smem_tc + 2 * kParts * S::kCB, dxa, r0, 0);
    __syncthreads();
    store_rows<T, kPT>(dx + (((long long)b * L + t0) * H + h) * P, (long long)H * P,
                       smem_tc + 2 * kParts * S::kCB, rows, P);
    if (warp == 0) {
      // the chunk's last position: sum_j f_j + exp(a_cum[-1]) <G, entering>
      float fs = fbuf[4 * lane] + fbuf[4 * lane + 1] + fbuf[4 * lane + 2] + fbuf[4 * lane + 3];
      float ds = lane < kThreads / 32 ? red[lane] : 0.f;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        fs += __shfl_xor_sync(0xffffffffu, fs, off);
        ds += __shfl_xor_sync(0xffffffffu, ds, off);
      }
      float v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) v[q] = dacc[4 * lane + q];
      if (lane == 31) v[3] += fs + expf(last) * ds;
      // reverse cumulative sum: within the lane, then across lanes
#pragma unroll
      for (int q = 2; q >= 0; --q) v[q] += v[q + 1];
      float incl = v[0];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float down = __shfl_down_sync(0xffffffffu, incl, off);
        if (lane + off < 32) incl += down;
      }
      float after = __shfl_down_sync(0xffffffffu, incl, 1);
      if (lane == 31) after = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int t = 4 * lane + q;
        if (t < rows) da[((long long)b * L + t0 + t) * H + h] = v[q] + after;
      }
    }
  }
  const int G = H / r;
  __syncthreads();  // every tile is read: C and B's space takes the staged dB
#pragma unroll
  for (int nt = 0; nt < NP / 64; ++nt) stage_tile<T, NP>(smem_tc, db[nt], r0, 64 * nt);
  __syncthreads();
  store_rows<T, NP>(dB + (((long long)b * L + t0) * G + gi) * N, (long long)G * N, smem_tc, rows,
                    N);
}

template <typename T, int NP>
cudaError_t launch_backward(const T* x, const T* gy, const float* a, const T* Bm, const T* Cm,
                            const float* gstate, float* work, T* dx, float* da, T* dB, T* dC,
                            int Bsz, int L, int H, int P, int N, int r, Strides sx, Strides sg,
                            Strides sa, Strides sb, Strides sc, cudaStream_t stream) {
  const int n_chunks = (L + kChunk - 1) / kChunk;
  const long long PN = (long long)P * N, heads = (long long)Bsz * H * n_chunks;
  float* ws_s = work;
  float* ws_g = ws_s + heads * PN;
  float* decay = ws_g + heads * PN;
  float* darow = decay + heads;
  using SS = SumsSmem<T, NP>;
  using CS = ChunkSmem<T, NP>;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(scan_bwd_sums<T, NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  SS::kBytes)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(scan_bwd_dc<T, NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  CS::kBytes)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(scan_bwd_dxdb<T, NP>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, CS::kBytes)) !=
          cudaSuccess)
    return err;
  scan_bwd_sums<T, NP><<<dim3(n_chunks, H, 2 * Bsz), kThreads, SS::kBytes, stream>>>(
      x, gy, a, Bm, Cm, ws_s, ws_g, decay, L, H, P, N, n_chunks, sx, sg, sa, sb, sc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int per_head = (int)((PN + kPassThreads - 1) / kPassThreads);
  scan_bwd_pass<<<per_head * Bsz * H, kPassThreads, 0, stream>>>(ws_s, ws_g, decay, gstate,
                                                                 n_chunks, PN, per_head);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const dim3 grid(n_chunks, H / r, Bsz);
  scan_bwd_dc<T, NP><<<grid, kThreads, CS::kBytes, stream>>>(x, gy, a, Bm, Cm, ws_s, darow, dC, L,
                                                             H, P, N, n_chunks, r, sx, sg, sa, sb,
                                                             sc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  scan_bwd_dxdb<T, NP><<<grid, kThreads, CS::kBytes, stream>>>(x, gy, a, Bm, Cm, ws_s, ws_g, darow,
                                                               dx, da, dB, L, H, P, N, n_chunks,
                                                               r, sx, sg, sa, sb, sc);
  return cudaGetLastError();
}

template <typename T>
cudaError_t backward(const void* x, const void* gy, const float* a, const void* Bm, const void* Cm,
                     const float* gstate, float* work, void* dx, float* da, void* dB, void* dC,
                     int Bsz, int L, int H, int P, int N, int r, Strides sx, Strides sg,
                     Strides sa, Strides sb, Strides sc, cudaStream_t stream) {
  const auto t = [](const void* p) { return static_cast<const T*>(p); };
  const auto o = [](void* p) { return static_cast<T*>(p); };
  return N <= 64 ? launch_backward<T, 64>(t(x), t(gy), a, t(Bm), t(Cm), gstate, work, o(dx), da,
                                          o(dB), o(dC), Bsz, L, H, P, N, r, sx, sg, sa, sb, sc,
                                          stream)
                 : launch_backward<T, 128>(t(x), t(gy), a, t(Bm), t(Cm), gstate, work, o(dx), da,
                                           o(dB), o(dC), Bsz, L, H, P, N, r, sx, sg, sa, sb, sc,
                                           stream);
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


// The vector-Jacobian product of the scan above (same shapes, strides and
// dtype codes) for the cotangent gy (b, l, h, p) of y, in x's dtype with
// its own strides, and gstate, the fp32 (b, h, p, n) contiguous cotangent
// of the final state (null: zero).  Writes dx (b, l, h, p) and dB, dC (b,
// l, h / heads_per_group, n) contiguous in x's dtype, dB and dC summed over
// each group's heads, and da (b, l, h) fp32 contiguous.  p must be at most
// 64.  work holds b * h * c * (2 * p * n + 1 + ssd_scan_chunk()) fp32
// values, c = ceil(l / ssd_scan_chunk()).
int ssd_scan_backward(const void* x, const void* gy, const void* a, const void* Bm, const void* Cm,
                      const void* gstate, void* work, void* dx, void* da, void* dB, void* dC,
                      int Bsz, int L, int H, int P, int N, long long x_sb, long long x_ss,
                      long long x_sh, long long g_sb, long long g_ss, long long g_sh,
                      long long a_sb, long long a_ss, long long a_sh, long long b_sb,
                      long long b_ss, long long b_sh, long long c_sb, long long c_ss,
                      long long c_sh, int heads_per_group, int dtype, int device, void* stream) {
  if (Bsz < 1 || L < 1 || H < 1 || P < 1 || N < 1 || N > kMaxState || P > tc::kPT ||
      H > 65535 || Bsz > 32767 || heads_per_group < 1 || H % heads_per_group || work == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Strides sx{x_sb, x_ss, x_sh}, sg{g_sb, g_ss, g_sh}, sa{a_sb, a_ss, a_sh},
      sb{b_sb, b_ss, b_sh, heads_per_group}, sc{c_sb, c_ss, c_sh, heads_per_group};
  const float* af = static_cast<const float*>(a);
  const float* gs = static_cast<const float*>(gstate);
  float* wf = static_cast<float*>(work);
  float* daf = static_cast<float*>(da);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    err = tc::backward<float>(x, gy, af, Bm, Cm, gs, wf, dx, daf, dB, dC, Bsz, L, H, P, N,
                              heads_per_group, sx, sg, sa, sb, sc, s);
  else if (dtype == kBF16)
    err = tc::backward<tc::bf16>(x, gy, af, Bm, Cm, gs, wf, dx, daf, dB, dC, Bsz, L, H, P, N,
                                 heads_per_group, sx, sg, sa, sb, sc, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)err;
}

}  // extern "C"

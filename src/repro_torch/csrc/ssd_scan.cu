// Hand-written Hopper (sm_90a) kernel for the Mamba2 SSD chunked scan
// (state-space duality), forward only.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/ssd_scan.py:
//   ssd_kernel  <- _ssd_kernel (ssd_scan.py:24), pallas_call :84
//
// With x (b, l, h, p) already scaled by dt, a (b, l, h) = A*dt <= 0 and
// B, C (b, l, h, n), for each (batch, head), tile after tile of positions,
// every sum in fp32 and the state starting at zero:
//   a_cum = cumsum(a)                                   (within the tile)
//   L[i][j] = exp(i >= j ? a_cum[i] - a_cum[j] : -1e30)
//   y = ((C . B^T) * L) . x + exp(a_cum) * (C . state^T)
//   state <- exp(a_cum[-1]) * state + x^T . (B * exp(a_cum[-1] - a_cum))
// y is (b, l, h, p), contiguous, in x's dtype (bf16 rounded to nearest);
// the final state, when asked for, is (b, h, p, n) fp32, contiguous.
//
// What bounds it: at the main path's shapes the work is ~32 GFLOP a layer
// for mamba2-130m (4 x 4096 tokens, 24 heads, p 64, n 128; counted with the
// reference's chunk of 128 and full q x q products) against ~114 MB (bf16 x
// and y, fp32 a and state, B and C read once), so the bf16 tensor cores
// and the memory would bound it near 0.034 ms; the products here are fp32
// FMAs, as the reference computes them in fp32, so the bound that applies
// to this design is the 67 TFLOP/s fp32 peak (~0.48 ms).  Moving the
// products to wgmma, and the chunk-parallel three-pass form (chunk states,
// state passing, chunk outputs), are later work.
//
// What the simple design does about it:
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
// - B and C are read through batch, time and head strides with a unit
//   stride in n, so the head-broadcast views that models/ssm.py passes
//   (head stride 0) are read in place and no (b, l, h, n) copy is made.
// - Numerics: the segment sums are the reference's cumsum differences, all
//   exps have arguments <= 0, no fast math (expf).  Positions at or past l
//   load x = 0, a = 0 and B = C = 0, so a ragged tail leaves the state
//   exact (decay exp(0), nothing added) and is never written to y.  All
//   offsets are 64-bit.
//
// Interface: plain C, bound with ctypes.  The entry point sets the device,
// launches on the caller's stream, does not synchronise, allocates nothing
// and returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

struct Strides {
  long long b, s, h;  // elements: batch, time, head; the last dim has stride 1
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
  const T* bh = Bm + b * sb.b + h * sb.h;
  const T* ch = Cm + b * sc.b + h * sc.h;
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

}  // namespace

extern "C" {

const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// y (b, l, h, p) contiguous = the SSD scan of x (b, l, h, p), a (b, l, h)
// fp32 and B, C (b, l, h, n), each given by element strides (batch, time,
// head) with a unit stride in its last dim; x, B, C and y share dtype (0
// fp32, 1 bf16).  When state is not null it receives the fp32 (b, h, p, n)
// state after position l - 1, contiguous.
int ssd_scan_launch(const void* x, const void* a, const void* Bm, const void* Cm, void* y,
                    void* state, int Bsz, int L, int H, int P, int N, long long x_sb,
                    long long x_ss, long long x_sh, long long a_sb, long long a_ss,
                    long long a_sh, long long b_sb, long long b_ss, long long b_sh,
                    long long c_sb, long long c_ss, long long c_sh, int dtype, int device,
                    void* stream) {
  if (Bsz < 1 || L < 1 || H < 1 || P < 1 || N < 1 || N > kMaxState)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Strides sx{x_sb, x_ss, x_sh}, sa{a_sb, a_ss, a_sh}, sb{b_sb, b_ss, b_sh},
      sc{c_sb, c_ss, c_sh};
  const float* af = static_cast<const float*>(a);
  float* sf = static_cast<float*>(state);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) {
    err = dispatch<float>(x, af, Bm, Cm, y, sf, Bsz, L, H, P, N, sx, sa, sb, sc, s);
  } else if (dtype == kBF16) {
    err = dispatch<__nv_bfloat16>(x, af, Bm, Cm, y, sf, Bsz, L, H, P, N, sx, sa, sb, sc, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}

}  // extern "C"

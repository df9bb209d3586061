// Hand-written Hopper (sm_90a) kernel for causal, windowed, soft-capped GQA
// attention with an online softmax (flash attention, forward only).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/flash_attention.py:
//   flash_kernel  <- _flash_kernel (flash_attention.py:22), pallas_call :100
//
// With q (B, H, S, d), k and v (B, Hkv, S, d), H % Hkv == 0, query head h
// reading kv head h / (H / Hkv), and every sum in fp32:
//   q' = fp32(q) * (1/sqrt(d))                   (scaled before the product)
//   s  = q' . k^T;  s = cap * tanh(s / cap) if cap > 0
//   valid(row, col) = col < S && (!causal || row >= col)
//                     && (window <= 0 || row - col < window)
//   s = valid ? s : -1e30;  online max m, sum-exp l and accumulator acc over
//   kv tiles, p = valid ? exp(s - m) : 0;  out = acc / max(l, 1e-30)
// out is (B, H, S, d), contiguous, in q's dtype (bf16 rounded to nearest).
//
// What bounds it: operations.  Each attended (row, col) pair costs 4*d flops
// (q.k and p.v) against bytes that are read once per query tile; at the main
// path's shape (B 2, H 8, S 5120, d 256) a call is ~210 GFLOP against
// ~126 MB.  This first kernel does its products with fp32 FMAs, as the
// reference does them in fp32, so its bound is the 67 TFLOP/s fp32 peak,
// not the bf16 tensor cores; moving the products to wgmma is later work.
//
// What the simple design does about it: one block of 256 threads per
// (query tile of 64 rows, head, batch).  The block keeps its q tile, one
// 64-row k tile, one 64-row v tile and the 64 x 64 probabilities in shared
// memory as fp32 (213,760 bytes at d 256, so the kernel opts into more than
// 48 KB of dynamic shared memory), and walks the kv tiles in a loop that
// takes the place of the Pallas grid's sequential kv axis.  Thread (ty, tx)
// of a 16 x 16 grid owns rows ty + 16i (i < 4) of the tile: a 4 x 4 block
// of scores (columns tx + 16j) and a 4 x d/16 block of the accumulator
// (columns 64c + 4tx + e), so the row max and row sum are four shuffles
// within a half-warp and the accumulator never leaves registers.  Shared
// reads are 16-byte vectors; the q and k rows are padded by 4 floats so the
// k reads of a quarter-warp fall on distinct banks.  Tiles that the causal
// mask or the window masks for every row of the query tile are skipped:
// that is exact, since a fully masked tile changes neither m, l nor acc.
// Query tiles run latest first, so the longest rows start first.
//
// Layout: q, k and v are taken with element strides for batch, head and
// time and a unit stride in the head dimension, so the (B, S, H, d) buffers
// that models/attention.py hands over through swapaxes views are read in
// place with no copy (a copy of q, k and v costs more than 100 MB a call at
// the main shape).  Head dims up to 256 are padded with zeros to 64, 128 or
// 256 in shared memory.  All offsets are 64-bit.  No fast math: expf, tanhf
// and IEEE division.
//
// Interface: plain C, bound with ctypes.  The entry point sets the device,
// launches on the caller's stream, does not synchronise, allocates nothing
// and returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;            // query rows of a block
constexpr int kBK = 64;            // kv rows of a tile
constexpr int kThreads = 256;      // a 16 x 16 grid of threads
constexpr int kMaxHeadDim = 256;
constexpr float kNeg = -1e30f;     // the reference's mask value
constexpr float kMinL = 1e-30f;    // the reference's floor on l
static_assert(kBQ == kBK, "load_tile moves 64-row tiles of q, k and v alike");

enum Dtype { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

struct Strides {
  long long b, h, s;  // elements; the head dimension has stride 1
};

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
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* __restrict__ src,
                                          long long stride_s, int row0, int S, int d,
                                          float mul) {
  for (int idx = threadIdx.x; idx < kBK * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    const int row = row0 + r;
    float x = 0.f;
    if (row < S && c < d) x = to_f32(src[(long long)row * stride_s + c]) * mul;
    dst[r * ld + c] = x;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ out, int H, int group, int S, int d, Strides sq, Strides sk,
             Strides sv, int causal, int window, float softcap, float scale) {
  constexpr int kLdQK = Tile<D>::kLdQK, kLdP = Tile<D>::kLdP, kNC = D / 64;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // kBQ x kLdQK, pre-scaled
  float* Ks = Qs + kBQ * kLdQK;                 // kBK x kLdQK
  float* Vs = Ks + kBK * kLdQK;                 // kBK x D
  float* Ps = Vs + kBK * D;                     // kBQ x kLdP

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // latest query tile first
  const int h = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const T* qh = q + b * sq.b + h * sq.h;
  const T* kh = k + b * sk.b + (long long)(h / group) * sk.h;
  const T* vh = v + b * sv.b + (long long)(h / group) * sv.h;

  load_tile<T, D>(Qs, kLdQK, qh, sq.s, q0, S, d, scale);

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
    load_tile<T, D>(Ks, kLdQK, kh, sk.s, k0, S, d, 1.f);
    load_tile<T, D>(Vs, D, vh, sv.s, k0, S, d, 1.f);
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

  T* oh = out + ((long long)b * H + h) * S * d;
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
        if (col < d) oh[(long long)row * d + col] = from_f32<T>(acc[i][c][e] / denom);
      }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B, int H,
                   int Hkv, int S, int d, Strides sq, Strides sk, Strides sv, int causal,
                   int window, float softcap, float scale, cudaStream_t stream) {
  const size_t smem = Tile<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(flash_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), H, H / Hkv, S, d, sq, sk, sv, causal, window, softcap, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out, int B, int H,
                     int Hkv, int S, int d, Strides sq, Strides sk, Strides sv, int causal,
                     int window, float softcap, float scale, cudaStream_t stream) {
  if (d <= 64)
    return launch<T, 64>(q, k, v, out, B, H, Hkv, S, d, sq, sk, sv, causal, window, softcap,
                         scale, stream);
  if (d <= 128)
    return launch<T, 128>(q, k, v, out, B, H, Hkv, S, d, sq, sk, sv, causal, window, softcap,
                          scale, stream);
  return launch<T, 256>(q, k, v, out, B, H, Hkv, S, d, sq, sk, sv, causal, window, softcap,
                        scale, stream);
}

}  // namespace

extern "C" {

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// out (B, H, S, d) contiguous = attention(q, k, v); q (B, H, S, d) and k, v
// (B, Hkv, S, d) given by element strides (batch, head, time) with a unit
// head-dim stride; all four share dtype (0 fp32, 1 bf16).  window <= 0 and
// softcap <= 0 turn those features off.
int flash_attention_launch(const void* q, const void* k, const void* v, void* out, int B,
                           int H, int Hkv, int S, int d, long long q_sb, long long q_sh,
                           long long q_ss, long long k_sb, long long k_sh, long long k_ss,
                           long long v_sb, long long v_sh, long long v_ss, int causal,
                           int window, float softcap, float scale, int dtype, int device,
                           void* stream) {
  if (B < 1 || H < 1 || Hkv < 1 || H % Hkv || S < 1 || d < 1 || d > kMaxHeadDim)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Strides sq{q_sb, q_sh, q_ss}, sk{k_sb, k_sh, k_ss}, sv{v_sb, v_sh, v_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) {
    err = dispatch<float>(q, k, v, out, B, H, Hkv, S, d, sq, sk, sv, causal, window, softcap,
                          scale, s);
  } else if (dtype == kBF16) {
    err = dispatch<__nv_bfloat16>(q, k, v, out, B, H, Hkv, S, d, sq, sk, sv, causal, window,
                                  softcap, scale, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}

}  // extern "C"

// Hand-written Hopper (sm_90a) kernels for the federated server merge.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/fed_agg.py:
//   fed_agg_kernel        <- _fed_agg_kernel (fed_agg.py:43), pallas_call :68
//   fed_agg_apply_kernel  <- _make_apply_kernel (fed_agg.py:112), pallas_call :192
//
// Both read a (K, P) matrix of K flattened client updates, row k starting
// k * ld elements after row 0 (ld >= P: ld = P for a contiguous matrix, the
// full padded width for one P slab of a wider matrix, as the sharded merge
// of kernels/fed_agg.py hands over), and reduce over K for every column p:
//   fed_agg        out[p] = sum_k c[k] * U[k, p]            (fp32 accumulate)
//   fed_agg_apply  s = sum_k c[k] * U[k, p]; d = mix * (s - g[p]);
//                  moment update for the server optimizer; out = g + lr * step;
//                  one partial sum of d*d per block (the wrapper takes the sqrt
//                  of their sum, as fed_agg.py:207 does outside its pallas_call).
//
// What bounds them: device-memory bytes.  Each U element is read once and used
// in one multiply-add, about 0.25 flop/byte for fp32, far below the ~20
// flop/byte at which the H100's fp32 units would become the limit.  Nothing
// here can use wgmma or TMA: there is no product to tile.
//
// What the simple design does about it: one thread owns VEC consecutive
// columns and walks k = 0..K-1, so every load of a warp covers one contiguous
// stretch of a row (coalesced), every byte of U, g, m and v crosses the bus
// once, and the K coefficients sit in shared memory.  VEC is the widest load
// (up to 16 bytes) that P, ld and the pointers' alignment allow; when P or ld
// is odd or a pointer is misaligned every row is read with scalar loads.  A grid-stride
// loop over column groups keeps a bounded grid.  Arithmetic uses the _rn
// intrinsics so that nvcc does not contract a*b+c into an FMA: the kernels
// then round exactly like the plain PyTorch versions in
// repro_torch/kernels/fed_agg.py, which take the K-sum in the same order.
//
// Interface: plain C, bound with ctypes.  Each entry point sets the device,
// launches on the caller's stream, does not synchronise, allocates nothing
// and returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxClients = 12288;  // K floats in 48 KB of shared memory

enum Dtype { kF32 = 0, kBF16 = 1 };
enum Opt { kSgd = 0, kFedAvgM = 1, kFedAdagrad = 2, kFedAdam = 3, kFedYogi = 4 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// VEC elements moved by one load or store instruction.
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__device__ __forceinline__ void load_f32(const T* __restrict__ p, float (&x)[VEC]) {
  const Pack<T, VEC> pk = *reinterpret_cast<const Pack<T, VEC>*>(p);
#pragma unroll
  for (int j = 0; j < VEC; ++j) x[j] = to_f32(pk.v[j]);
}

template <typename T, int VEC>
__device__ __forceinline__ void store_f32(T* __restrict__ p, const float (&x)[VEC]) {
  Pack<T, VEC> pk;
#pragma unroll
  for (int j = 0; j < VEC; ++j) pk.v[j] = from_f32<T>(x[j]);
  *reinterpret_cast<Pack<T, VEC>*>(p) = pk;
}

// acc[j] = sum_k c[k] * U[k, p0 + j], summed over k in order from 0.
template <typename T, int VEC>
__device__ __forceinline__ void weighted_sum(const T* __restrict__ U, const float* sc,
                                             int K, long long ld, long long p0,
                                             float (&acc)[VEC]) {
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float x[VEC];
    load_f32<T, VEC>(U + (long long)k * ld + p0, x);
    const float ck = sc[k];
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = __fadd_rn(acc[j], __fmul_rn(ck, x[j]));
  }
}

__device__ __forceinline__ void stage_coeffs(const float* __restrict__ coeffs, float* sc, int K) {
  for (int k = threadIdx.x; k < K; k += blockDim.x) sc[k] = coeffs[k];
  __syncthreads();
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
fed_agg_kernel(const T* __restrict__ U, const float* __restrict__ coeffs,
               T* __restrict__ out, int K, long long P, long long ld) {
  extern __shared__ float sc[];
  stage_coeffs(coeffs, sc, K);
  const long long groups = P / VEC;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long gi = (long long)blockIdx.x * blockDim.x + threadIdx.x; gi < groups;
       gi += stride) {
    const long long p0 = gi * VEC;
    float acc[VEC];
    weighted_sum<T, VEC>(U, sc, K, ld, p0, acc);
    store_f32<T, VEC>(out + p0, acc);
  }
}

// One column of the server step; the formulas are those of fed_agg.py:136-157.
template <int OPT>
__device__ __forceinline__ void server_step(float s, float g, float m0, float v0,
                                            float lr, float mix, float b1, float b2,
                                            float eps, float& out, float& m, float& v,
                                            float& dsq) {
  const float delta = __fmul_rn(mix, __fsub_rn(s, g));
  dsq = __fmul_rn(delta, delta);
  float step;
  if (OPT == kSgd || OPT == kFedAvgM) {
    m = __fadd_rn(__fmul_rn(b1, m0), delta);
    v = v0;
    step = m;
  } else {
    m = __fadd_rn(__fmul_rn(b1, m0), __fmul_rn(__fsub_rn(1.f, b1), delta));
    if (OPT == kFedAdagrad) {
      v = __fadd_rn(v0, dsq);
    } else if (OPT == kFedAdam) {
      v = __fadd_rn(__fmul_rn(b2, v0), __fmul_rn(__fsub_rn(1.f, b2), dsq));
    } else {  // kFedYogi
      const float diff = __fsub_rn(v0, dsq);
      const float sgn = (diff > 0.f) ? 1.f : ((diff < 0.f) ? -1.f : 0.f);
      v = __fsub_rn(v0, __fmul_rn(__fmul_rn(__fsub_rn(1.f, b2), dsq), sgn));
    }
    step = __fdiv_rn(m, __fadd_rn(__fsqrt_rn(v), eps));
  }
  out = __fadd_rn(g, __fmul_rn(lr, step));
}

template <typename T, int VEC, int OPT>
__global__ void __launch_bounds__(kThreads)
fed_agg_apply_kernel(const T* __restrict__ U, const float* __restrict__ coeffs,
                     const float* __restrict__ g, const float* __restrict__ m,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ m_out, float* __restrict__ v_out,
                     float* __restrict__ partials, int K, long long P, long long ld,
                     float lr, float mix, float b1, float b2, float eps) {
  extern __shared__ float sc[];  // K coefficients, then one float per warp
  float* warp_sums = sc + K;
  stage_coeffs(coeffs, sc, K);
  float sq = 0.f;
  const long long groups = P / VEC;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long gi = (long long)blockIdx.x * blockDim.x + threadIdx.x; gi < groups;
       gi += stride) {
    const long long p0 = gi * VEC;
    float s[VEC], gv[VEC], mv[VEC], vv[VEC];
    weighted_sum<T, VEC>(U, sc, K, ld, p0, s);
    load_f32<float, VEC>(g + p0, gv);
    load_f32<float, VEC>(m + p0, mv);
    load_f32<float, VEC>(v + p0, vv);
    float o[VEC], mo[VEC], vo[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      float dsq;
      server_step<OPT>(s[j], gv[j], mv[j], vv[j], lr, mix, b1, b2, eps, o[j], mo[j],
                       vo[j], dsq);
      sq += dsq;
    }
    store_f32<float, VEC>(out + p0, o);
    store_f32<float, VEC>(m_out + p0, mo);
    store_f32<float, VEC>(v_out + p0, vo);
  }
  // block sum of d*d: warp shuffle, then one float per warp in shared memory
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sq += __shfl_down_sync(0xffffffffu, sq, off);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = sq;
  __syncthreads();
  if (warp == 0) {
    sq = (lane < kWarps) ? warp_sums[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sq += __shfl_down_sync(0xffffffffu, sq, off);
    if (lane == 0) partials[blockIdx.x] = sq;
  }
}

// Widest VEC <= max_vec (a power of two) with P % VEC == 0, ld % VEC == 0 and
// every pointer aligned to VEC of its own element size.
int pick_vec(long long P, long long ld, int max_vec, const void* const* ptrs,
             const int* elem_bytes, int n) {
  for (int vec = max_vec; vec > 1; vec >>= 1) {
    if (P % vec || ld % vec) continue;
    bool aligned = true;
    for (int i = 0; i < n; ++i)
      aligned = aligned && (reinterpret_cast<unsigned long long>(ptrs[i]) %
                            (unsigned long long)(vec * elem_bytes[i])) == 0;
    if (aligned) return vec;
  }
  return 1;
}

int grid_for(long long groups, int max_blocks) {
  long long blocks = (groups + kThreads - 1) / kThreads;
  if (blocks > max_blocks) blocks = max_blocks;
  return blocks < 1 ? 1 : (int)blocks;
}

template <typename T, int VEC>
void launch_agg(const void* U, const void* coeffs, void* out, int K, long long P,
                long long ld, cudaStream_t stream) {
  const int blocks = grid_for(P / VEC, 4096);
  fed_agg_kernel<T, VEC><<<blocks, kThreads, K * sizeof(float), stream>>>(
      static_cast<const T*>(U), static_cast<const float*>(coeffs), static_cast<T*>(out),
      K, P, ld);
}

template <typename T>
void dispatch_agg(const void* U, const void* coeffs, void* out, int K, long long P,
                  long long ld, cudaStream_t stream) {
  const void* ptrs[2] = {U, out};
  const int bytes[2] = {(int)sizeof(T), (int)sizeof(T)};
  switch (pick_vec(P, ld, 16 / (int)sizeof(T), ptrs, bytes, 2)) {
    case 8: launch_agg<T, 8>(U, coeffs, out, K, P, ld, stream); break;
    case 4: launch_agg<T, 4>(U, coeffs, out, K, P, ld, stream); break;
    case 2: launch_agg<T, 2>(U, coeffs, out, K, P, ld, stream); break;
    default: launch_agg<T, 1>(U, coeffs, out, K, P, ld, stream); break;
  }
}

struct ApplyArgs {
  const void* U;
  const float* coeffs;
  const float* g;
  const float* m;
  const float* v;
  float* out;
  float* m_out;
  float* v_out;
  float* partials;
  int n_partials;
  int K;
  long long P;
  long long ld;
  float lr, mix, b1, b2, eps;
};

template <typename T, int VEC, int OPT>
void launch_apply(const ApplyArgs& a, cudaStream_t stream) {
  const size_t smem = (a.K + kWarps) * sizeof(float);
  fed_agg_apply_kernel<T, VEC, OPT><<<a.n_partials, kThreads, smem, stream>>>(
      static_cast<const T*>(a.U), a.coeffs, a.g, a.m, a.v, a.out, a.m_out, a.v_out,
      a.partials, a.K, a.P, a.ld, a.lr, a.mix, a.b1, a.b2, a.eps);
}

template <typename T, int VEC>
bool dispatch_opt(const ApplyArgs& a, int opt, cudaStream_t stream) {
  switch (opt) {
    case kSgd: launch_apply<T, VEC, kSgd>(a, stream); return true;
    case kFedAvgM: launch_apply<T, VEC, kFedAvgM>(a, stream); return true;
    case kFedAdagrad: launch_apply<T, VEC, kFedAdagrad>(a, stream); return true;
    case kFedAdam: launch_apply<T, VEC, kFedAdam>(a, stream); return true;
    case kFedYogi: launch_apply<T, VEC, kFedYogi>(a, stream); return true;
    default: return false;
  }
}

template <typename T>
bool dispatch_apply(const ApplyArgs& a, int opt, cudaStream_t stream) {
  const void* ptrs[7] = {a.U, a.g, a.m, a.v, a.out, a.m_out, a.v_out};
  const int bytes[7] = {(int)sizeof(T), 4, 4, 4, 4, 4, 4};
  switch (pick_vec(a.P, a.ld, 4, ptrs, bytes, 7)) {
    case 4: return dispatch_opt<T, 4>(a, opt, stream);
    case 2: return dispatch_opt<T, 2>(a, opt, stream);
    default: return dispatch_opt<T, 1>(a, opt, stream);
  }
}

}  // namespace

extern "C" {

const char* fed_agg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// out (P,) = coeffs (K,) @ U (K, P) with row stride ld; U and out share dtype
// (0 fp32, 1 bf16).
int fed_agg_launch(const void* U, const void* coeffs, void* out, int K, long long P,
                   long long ld, int dtype, int device, void* stream) {
  if (K < 1 || K > kMaxClients || P < 1 || ld < P) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) {
    dispatch_agg<float>(U, coeffs, out, K, P, ld, s);
  } else if (dtype == kBF16) {
    dispatch_agg<__nv_bfloat16>(U, coeffs, out, K, P, ld, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The fused server step; U has row stride ld, g, m, v and the three outputs
// are fp32 (P,), partials is fp32 (n_partials,) and n_partials is the grid
// size.
int fed_agg_apply_launch(const void* U, const void* coeffs, const void* g, const void* m,
                         const void* v, void* out, void* m_out, void* v_out,
                         void* partials, int n_partials, int K, long long P,
                         long long ld, int dtype, int opt, float lr, float mix,
                         float b1, float b2, float eps, int device, void* stream) {
  if (K < 1 || K > kMaxClients || P < 1 || ld < P || n_partials < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const ApplyArgs a{U,
                    static_cast<const float*>(coeffs),
                    static_cast<const float*>(g),
                    static_cast<const float*>(m),
                    static_cast<const float*>(v),
                    static_cast<float*>(out),
                    static_cast<float*>(m_out),
                    static_cast<float*>(v_out),
                    static_cast<float*>(partials),
                    n_partials, K, P, ld, lr, mix, b1, b2, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool ok;
  if (dtype == kF32) {
    ok = dispatch_apply<float>(a, opt, s);
  } else if (dtype == kBF16) {
    ok = dispatch_apply<__nv_bfloat16>(a, opt, s);
  } else {
    ok = false;
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"

// Hand-written Hopper (sm_90a) kernel for the local Adam / AdamW step of FL
// clients, over every leaf of a params tree in one pass.
//
// Replaces no Pallas kernel.  The JAX package's Adam (src/repro/optim/
// optimizers.py) is jnp under jit, which XLA fuses into one loop a leaf; the
// port's eager PyTorch ran it as about 14 elementwise passes a leaf (FedProx
// term, both moments, the bias-corrected step, the apply), each a kernel
// launch and a trip through device memory.  On the executor's (K, P) stacked
// trees (K = 64, P = 6,603,710: 1.69 GB a fp32 tree) those passes took two
// thirds of a local step.
//
// For each element of each leaf (p a param, g its grad, m and v the fp32
// moments, a the optional FedProx anchor, shared by the K rows of a stacked
// leaf):
//   g' = g + mu * (p - a)                          (only with an anchor)
//   m' = b1 * m + (1 - b1) * g'
//   v' = b2 * v + (1 - b2) * g'^2
//   u  = ((-lr) * (m' * (1 / bc1))) / (sqrt(v' * (1 / bc2)) + eps)
//   u  = u - (lr * wd) * p                         (only with weight decay)
//   out = p + u   (APPLY: the new param)    or    out = u   (the fp32 update)
//
// What bounds it: device-memory bytes.  About 15 flops an element against 28
// bytes (read p, g, m, v; write p, m, v in fp32): 7 * 4 * K * P bytes a step
// (+ 4 * P with an anchor), 11.83 GB at the CNN's (64, P), 3.53 ms at 3.35
// TB/s.  Nothing here can use wgmma or TMA.
//
// What the design does about it: every byte crosses the bus once.  One launch
// takes a table of up to kMaxLeaves leaves (pointers and lengths, a kernel
// argument read from the constant bank), so a small model's step is one
// launch.  The leaves' elements are cut into tiles of kTile; a grid-stride
// loop over the tiles finds each tile's leaf by a binary search of the
// table's first-tile offsets.  A leaf whose pointers are aligned (and whose
// anchor's length is a multiple of 4) is read and written 4 elements at a
// time (16-byte fp32 accesses), with a scalar tail past its last multiple of
// 4; other leaves are read element by element.  The outputs are new buffers:
// the inputs are not written, as PyTorch's functional step leaves them.
//
// The update-only form (APPLY false) serves Adam's `update` where a caller
// rebuilds an optimizer around it, as the benchmark's FL driver does to read
// the first step's gradients; every step of the port itself (the executor,
// the eager loop, make_train_step) applies in the kernel.
//
// Rounding: the kernel rounds exactly as PyTorch's unfused passes on the
// card (kernels/adam.py adam_plain).  Every operation is a _rn intrinsic, so
// nvcc contracts nothing into an FMA; the scalars arrive rounded to fp32 as
// PyTorch rounds a Python number; a division by a host scalar is a product
// by its reciprocal, taken in double and rounded to fp32, as PyTorch's CUDA
// true division by a CPU scalar computes it on the H100 (with the
// reciprocal of fp32(0.001) taken in fp32, a third of the updates came out
// an ulp apart); bf16 params and grads are rounded where PyTorch's bf16
// passes round them (p - a, mu * d and g + mu * d; the update before the
// add, and the sum).
//
// Interface: plain C, bound with ctypes.  The entry point sets the device,
// launches one kernel on the caller's stream, does not synchronise,
// allocates nothing and returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;
constexpr long long kTile = (long long)kThreads * kVec * 4;  // 4 vectors a thread
constexpr int kMaxLeaves = 36;

enum Dtype { kF32 = 0, kBF16 = 1 };

struct Leaf {
  const void* p;
  const void* g;
  const float* m;
  const float* v;
  const void* a;   // anchor, or nullptr
  void* out;       // new param (APPLY) or fp32 update
  float* m_out;
  float* v_out;
  long long n;      // elements of the leaf
  long long row;    // elements of the anchor (the leaf repeats it n / row times)
  long long tile0;  // the leaf's first tile in the launch
  int vec;          // kVec or 1
};

struct Table {
  Leaf leaf[kMaxLeaves];
  long long n_tiles;
  int n_leaves;
};

struct Hyper {
  float neg_lr, b1, one_b1, b2, one_b2, inv_bc1, inv_bc2, eps, lr_wd, mu;
  int wd;
};

// kernel arguments live in 4 KB of the constant bank
static_assert(sizeof(Table) + sizeof(Hyper) <= 4000, "table too large");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T and back: the value a PyTorch op with a T output holds
template <typename T> __device__ __forceinline__ float in(float x) {
  return to_f32(from_f32<T>(x));
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__device__ __forceinline__ void load(const void* base, long long i, float (&x)[VEC]) {
  const Pack<T, VEC> pk = reinterpret_cast<const Pack<T, VEC>*>(static_cast<const T*>(base) + i)[0];
#pragma unroll
  for (int j = 0; j < VEC; ++j) x[j] = to_f32(pk.v[j]);
}

template <typename T, int VEC>
__device__ __forceinline__ void store(void* base, long long i, const float (&x)[VEC]) {
  Pack<T, VEC> pk;
#pragma unroll
  for (int j = 0; j < VEC; ++j) pk.v[j] = from_f32<T>(x[j]);
  reinterpret_cast<Pack<T, VEC>*>(static_cast<T*>(base) + i)[0] = pk;
}

// One element; the operations and their order are adam_plain's.
template <typename T, bool APPLY>
__device__ __forceinline__ void adam_elem(float p, float g, const float* a, float m0,
                                          float v0, const Hyper& h, float& out,
                                          float& m1, float& v1) {
  if (a != nullptr) {
    const float d = in<T>(__fsub_rn(p, *a));
    g = in<T>(__fadd_rn(g, in<T>(__fmul_rn(h.mu, d))));
  }
  m1 = __fadd_rn(__fmul_rn(h.b1, m0), __fmul_rn(h.one_b1, g));
  v1 = __fadd_rn(__fmul_rn(h.b2, v0), __fmul_rn(h.one_b2, __fmul_rn(g, g)));
  float u = __fdiv_rn(__fmul_rn(h.neg_lr, __fmul_rn(m1, h.inv_bc1)),
                      __fadd_rn(__fsqrt_rn(__fmul_rn(v1, h.inv_bc2)), h.eps));
  if (h.wd) u = __fsub_rn(u, __fmul_rn(h.lr_wd, p));
  out = APPLY ? in<T>(__fadd_rn(p, in<T>(u))) : u;
}

// Elements [e0, e1) of leaf L, VEC at a time; e0 and e1 - e0 are multiples of VEC.
template <typename T, bool APPLY, int VEC>
__device__ __forceinline__ void run(const Leaf& L, const Hyper& h, long long e0,
                                    long long e1) {
  using TO = typename std::conditional<APPLY, T, float>::type;
  const bool need_p = APPLY || h.wd || L.a != nullptr;
  for (long long e = e0 + (long long)threadIdx.x * VEC; e < e1;
       e += (long long)kThreads * VEC) {
    float p[VEC], g[VEC], m[VEC], v[VEC], a[VEC];
    if (need_p) {
      load<T, VEC>(L.p, e, p);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) p[j] = 0.f;
    }
    load<T, VEC>(L.g, e, g);
    load<float, VEC>(L.m, e, m);
    load<float, VEC>(L.v, e, v);
    if (L.a != nullptr) load<T, VEC>(L.a, e % L.row, a);
    float o[VEC], mo[VEC], vo[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      adam_elem<T, APPLY>(p[j], g[j], L.a != nullptr ? &a[j] : nullptr, m[j], v[j],
                               h, o[j], mo[j], vo[j]);
    store<TO, VEC>(L.out, e, o);
    store<float, VEC>(L.m_out, e, mo);
    store<float, VEC>(L.v_out, e, vo);
  }
}

template <typename T, bool APPLY>
__global__ void __launch_bounds__(kThreads)
adam_kernel(const __grid_constant__ Table t, const Hyper h) {
  for (long long tile = blockIdx.x; tile < t.n_tiles; tile += gridDim.x) {
    int lo = 0, hi = t.n_leaves - 1;  // last leaf whose first tile is <= tile
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (t.leaf[mid].tile0 <= tile) lo = mid; else hi = mid - 1;
    }
    const Leaf& L = t.leaf[lo];
    const long long e0 = (tile - L.tile0) * kTile;
    const long long e1 = e0 + kTile < L.n ? e0 + kTile : L.n;
    if (L.vec == kVec) {
      // vectors up to the leaf's last multiple of kVec, then its scalar tail
      const long long body = L.n - L.n % kVec;
      const long long mid = body < e0 ? e0 : (body > e1 ? e1 : body);
      run<T, APPLY, kVec>(L, h, e0, mid);
      run<T, APPLY, 1>(L, h, mid, e1);
    } else {
      run<T, APPLY, 1>(L, h, e0, e1);
    }
  }
}

bool aligned(const void* ptr, int bytes) {
  return ptr == nullptr || reinterpret_cast<unsigned long long>(ptr) % bytes == 0;
}

// One wave of resident blocks: each walks an equal share of the tiles.
template <typename T, bool APPLY>
void launch(const Table& t, const Hyper& h, int device, cudaStream_t stream) {
  int sms = 0, per_sm = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess ||
      sms < 1)
    sms = 132;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, adam_kernel<T, APPLY>,
                                                    kThreads, 0) != cudaSuccess ||
      per_sm < 1)
    per_sm = 1;
  long long blocks = (long long)sms * per_sm;
  if (blocks > t.n_tiles) blocks = t.n_tiles;
  adam_kernel<T, APPLY><<<(int)blocks, kThreads, 0, stream>>>(t, h);
}

template <typename T>
void dispatch_apply(bool apply, const Table& t, const Hyper& h, int device, cudaStream_t s) {
  if (apply) launch<T, true>(t, h, device, s);
  else launch<T, false>(t, h, device, s);
}

}  // namespace

extern "C" {

const char* adam_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// One launch over n_leaves <= 36 leaves.  ptrs holds 8 pointers a leaf (p, g,
// m, v, anchor or null, out, m_out, v_out), sizes 2 numbers a leaf (its
// elements, its anchor's elements or 0).  p, g and the anchor are of dtype
// (0 fp32, 1 bf16); m, v, m_out and v_out fp32; out of dtype with apply, fp32
// without.  Every leaf contiguous; the hyperparameters as adam_elem reads them
// (wd: nonzero to subtract lr_wd * p).
int adam_launch(const void* const* ptrs, const long long* sizes, int n_leaves, int dtype,
                int apply, float neg_lr, float b1, float one_b1, float b2, float one_b2,
                float inv_bc1, float inv_bc2, float eps, float lr_wd, float mu, int wd,
                int device, void* stream) {
  if (n_leaves < 1 || n_leaves > kMaxLeaves || dtype < kF32 || dtype > kBF16)
    return (int)cudaErrorInvalidValue;
  const int pb = dtype == kF32 ? 4 : 2;
  const int ob = apply ? pb : 4;
  Table t{};
  long long tiles = 0;
  for (int i = 0; i < n_leaves; ++i) {
    const void* const* q = ptrs + 8 * i;
    Leaf& L = t.leaf[i];
    L = Leaf{q[0], q[1], static_cast<const float*>(q[2]), static_cast<const float*>(q[3]),
             q[4], const_cast<void*>(q[5]), static_cast<float*>(const_cast<void*>(q[6])),
             static_cast<float*>(const_cast<void*>(q[7])), sizes[2 * i], sizes[2 * i + 1],
             tiles, 1};
    if (L.n < 0 || (L.a != nullptr && (L.row < 1 || L.n % L.row)))
      return (int)cudaErrorInvalidValue;
    const bool vec = aligned(L.p, kVec * pb) && aligned(L.g, kVec * pb) &&
                     aligned(L.m, 16) && aligned(L.v, 16) && aligned(L.out, kVec * ob) &&
                     aligned(L.m_out, 16) && aligned(L.v_out, 16) &&
                     (L.a == nullptr || (aligned(L.a, kVec * pb) && L.row % kVec == 0));
    L.vec = vec ? kVec : 1;
    tiles += (L.n + kTile - 1) / kTile;
  }
  t.n_tiles = tiles;
  t.n_leaves = n_leaves;
  if (tiles == 0) return (int)cudaSuccess;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Hyper h{neg_lr, b1, one_b1, b2, one_b2, inv_bc1, inv_bc2, eps, lr_wd, mu, wd};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) dispatch_apply<float>(apply != 0, t, h, device, s);
  else dispatch_apply<__nv_bfloat16>(apply != 0, t, h, device, s);
  return (int)cudaGetLastError();
}

}  // extern "C"

// Checks the division that flash_attention.cu's bf16 kernel uses for its
// softcap (div_by.cuh: x * r with r = 1 / c, then one fma correction)
// against IEEE division, bit for bit, over every float32 x with |x| in
// [2^-100, 2^100].  The divisors are the arguments; with none, the
// divisors 50 and 30 (Gemma 2's caps), a few fixed ones and 109 random
// ones in [2^-20, 2^20).  Prints the mismatches of each divisor and exits
// 1 if there is any.  chip_smoke.py builds it and runs it on the configs'
// caps.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o check_division \
//       src/repro_torch/csrc/tools/check_division.cu && ./check_division [c ...]
#include <cstdio>
#include <cstdlib>
#include <vector>

#include "../div_by.cuh"

__global__ void sweep(float c, unsigned long long* bad) {
  const float r = 1.0f / c;
  for (unsigned long long i = blockIdx.x * (unsigned long long)blockDim.x + threadIdx.x;
       i < (1ull << 32); i += (unsigned long long)gridDim.x * blockDim.x) {
    const float x = __uint_as_float((unsigned)i);
    if (!(fabsf(x) >= 0x1p-100f && fabsf(x) <= 0x1p100f)) continue;
    if (__float_as_uint(div_by(x, c, r)) != __float_as_uint(__fdiv_rn(x, c))) atomicAdd(bad, 1ull);
  }
}

int main(int argc, char** argv) {
  std::vector<float> caps;
  for (int i = 1; i < argc; ++i) caps.push_back(strtof(argv[i], nullptr));
  if (caps.empty()) {
    for (float c : {50.f, 30.f, 20.f, 1.f, 3.f, 7.f, 0.1f, 1.9999999f, 1.5f, 1e-3f, 1e5f})
      caps.push_back(c);
    srand(1);
    while (caps.size() < 120) caps.push_back(ldexpf(1.f + rand() / (float)RAND_MAX, rand() % 40 - 20));
  }
  unsigned long long* bad;
  if (cudaMallocManaged(&bad, sizeof(*bad)) != cudaSuccess) return 2;
  unsigned long long total = 0;
  for (float c : caps) {
    *bad = 0;
    sweep<<<132 * 8, 256>>>(c, bad);
    if (cudaDeviceSynchronize() != cudaSuccess) return 2;
    printf("divisor %.9g: %llu mismatches\n", c, *bad);
    total += *bad;
  }
  printf("%zu divisors, %llu mismatches in all\n", caps.size(), total);
  cudaFree(bad);
  return total ? 1 : 0;
}

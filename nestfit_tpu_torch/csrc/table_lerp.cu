// Linear interpolation of a 1-D table at fractional positions.
//
// Replaces the TPU kernel nestfit_tpu/ops/tables.py::table_lerp
// (pallas_call at tables.py:81), which evaluated each lookup as a
// "hat"-weight contraction over the whole table because the TPU has no
// vector gather.  Here a lookup is what it is: for each element,
// s = clip(scaled, 0, N-1), i = min(floor(s), N-2), f = s - i, and
// out = (1-f) table[i] + f table[i+1] -- exact at the integer
// positions, so both endpoints come out exactly.
//
// Exactness: the blend is rounded after every operation, as the plain
// version (ops/tables.py::table_lerp_plain) rounds it, so the two agree
// bit for bit (prior_tables.cuh::lerp, the one copy of the arithmetic,
// which the whole-transform kernel prior_transform.cu shares).
//
// Bound on the H100: memory.  Each element reads 4 bytes and writes 4
// (8 B per element).  One thread per element; the table (2 KB at N = 500)
// is read through the read-only/L1 path, where every block finds it
// after the first touch, so no block spends a load-and-barrier phase
// copying it to shared memory.

#include <cuda_runtime.h>

#include "prior_tables.cuh"

namespace {

__global__ void table_lerp_kernel(const float* __restrict__ table, int N,
                                  const float* __restrict__ scaled,
                                  float* __restrict__ out, long long B) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= B) return;
  out[i] = prior_tables::lerp(table, N, scaled[i]);
}

}  // namespace

// Launches on ``stream`` of card ``device``.  Returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int table_lerp_launch(const float* table, int N,
                                 const float* scaled, float* out,
                                 long long B, int device, void* stream) {
  if (B <= 0) return 0;
  // the launch goes to the tensors' card, whatever this library's
  // runtime last had current
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  if (N < 2) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;
  const long long blocks = (B + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  table_lerp_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(table, N, scaled,
                                                          out, B);
  return static_cast<int>(cudaGetLastError());
}

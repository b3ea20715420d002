// The whole prior transform of a batch of unit-cube rows, one launch.
//
// No TPU kernel of its own: it replaces the per-prior chain of a
// PriorTransformer (priors/priors.py), which launched K2 (table_lerp.cu)
// once a tabulated prior, K3 (tapered_invert.cu) once a placed
// component, and the PyTorch operations between them (the parameter-major
// row writes and their copies, the placement's separations, its
// shrink-to-fit and its running interval), some 40 device operations a
// transform at ncomp 2, each a launch slot and a gap in a replayed CUDA
// graph for next to no work.
//
// The transformer is packed once (ops/tables.py::pack_program) into a
// PriorProgram passed by value (a __grid_constant__ parameter: the
// threads read its ops in place, with no copy of it to local memory), so
// a graph captures it with the launch:
// the op codes in the transformer's order, their parameter rows, the
// tables' device pointers and sizes, and the placement's constants, each
// a float32 as the plain operations round their Python scalars.  One
// thread a row loads the row's n_param x ncomp unit-cube values
// (parameter-major), applies the ops in order in registers, and writes
// the row once:
// - kPpf: the ppf lookup of the row's components (K2's lerp);
// - kDuplicate: the same, written to a second row too;
// - kConstant: the value;
// - kPlacement: the sequential resolved placement of the centroid row,
//   its minimum separations from the width row (which the program's
//   previous op has transformed), shrunk to fit when their sum exceeds
//   the velocity range, and each component by K3's tapered inversion
//   with exponent ncomp - 1 - i over the running interval (ncomp <= 3,
//   so the exponent is 0, 1 or 2).
//
// Exactness: bit for bit with PriorTransformer.transform(plain=True) and
// its kernel path.  The arithmetic of K2 and K3 is prior_tables.cuh's,
// shared with them; the placement's own operations repeat the plain ones
// one by one, each rounded on its own (the __f*_rn intrinsics):
// sep_scale * sqrt(s_i s_(i-1)), the sum of the separations in order,
// v_range / sep_tot as PyTorch computes a float over a tensor (the
// rounded reciprocal times the float), the shrink-to-fit select, and the
// running interval's sums.
//
// Bound on the H100: bytes, by count.  A row reads and writes 4 n_param
// ncomp bytes (48 B each way at the IRDC priors' ncomp 2), and each block
// copies the placement's cells table into shared memory as K3 does (32 N
// bytes, 16 KB at N = 500, served by L2 after the first block): 3.4 us
// at 51,200 rows at HBM's 3.35 TB/s.  The kernel takes several times
// that: each thread's chain of dependent loads (the row, the table's
// copy, K3's ceil(log2 N) probes a component, the ppf lerps) leaves few
// warps a multiprocessor to hide it at the path's widths (3,200 to
// 102,400 rows, 25 to 800 blocks on 132 multiprocessors).

#include <cuda_runtime.h>

#include "prior_tables.cuh"

// The program's layout, outside the unnamed namespace: the C launcher
// takes it, and a parameter of a type with internal linkage would give
// the launcher internal linkage too.
namespace prior_program {

constexpr int kThreads = 128;
constexpr int kMaxOps = 16;      // MAX_OPS in ops/tables.py
constexpr int kMaxVals = 48;     // MAX_VALS: n_param * ncomp
constexpr int kMaxPlaced = 3;    // components a placement takes
constexpr int kMaxCells = 1536;  // K3's shared-memory table, 48 KB

enum : int { kPpf = 0, kDuplicate = 1, kConstant = 2, kPlacement = 3 };

// One prior of the program (ops/tables.py::_PriorOp).
struct PriorOp {
  const float* table;  // ppf table (kPpf, kDuplicate; kPlacement: the
                       // centroid prior's, read at ncomp 1)
  int code;
  int row;             // the parameter row written
  int row2;            // kDuplicate: its second row; kPlacement: widths
  int n;               // the table's size
  float value;         // kConstant: the value; kPlacement: sep_scale
  float xmin, xmax, v_range, dx, center;   // kPlacement
};

// The packed transformer (ops/tables.py::_PriorProgram).
struct PriorProgram {
  const float4* cells;  // the placement's [N, 2] K3 table, or null
  int n_cells;
  int n_op, n_param, ncomp;
  PriorOp ops[kMaxOps];
};

static_assert(sizeof(PriorOp) == 48, "PriorOp layout");
static_assert(sizeof(PriorProgram) == 24 + 48 * kMaxOps,
              "PriorProgram layout");

}  // namespace prior_program

namespace {

using namespace prior_program;

// The placement of the C components of row op.row; th is the row.
__device__ void place(const PriorOp& op, float* th, int C,
                      const float4* cells, int n_probe) {
  const int iv = op.row * C, is = op.row2 * C;
  float u[kMaxPlaced];
  for (int c = 0; c < C; ++c) u[c] = th[iv + c];
  if (C == 1) {
    th[iv] = prior_tables::ppf(op.table, op.n, u[0]);
    return;
  }
  float seps[kMaxPlaced];
  seps[0] = 0.0f;
  float sep_tot = 0.0f;
  for (int i = 1; i < C; ++i) {
    seps[i] = __fmul_rn(
        __fsqrt_rn(__fmul_rn(th[is + i], th[is + i - 1])), op.value);
    sep_tot = i == 1 ? seps[1] : __fadd_rn(sep_tot, seps[i]);
  }
  // shrink to fit
  const float factor = sep_tot > op.v_range
      ? __fmul_rn(__frcp_rn(sep_tot), op.v_range) : 1.0f;
  sep_tot = __fmul_rn(sep_tot, factor);
  float v_lo = op.xmin;
  float v_hi = __fsub_rn(op.xmax, sep_tot);
  for (int i = 0; i < C; ++i) {
    const float sep = __fmul_rn(seps[i], factor);
    v_lo = __fadd_rn(v_lo, sep);
    v_hi = __fadd_rn(v_hi, sep);
    const int sf = C - 1 - i;
    float v;
    if (sf == 2) {
      v = prior_tables::tapered_invert<2>(cells, op.n, n_probe, u[i], v_lo,
                                          v_hi, op.xmin, op.dx, op.center);
    } else if (sf == 1) {
      v = prior_tables::tapered_invert<1>(cells, op.n, n_probe, u[i], v_lo,
                                          v_hi, op.xmin, op.dx, op.center);
    } else {
      v = prior_tables::tapered_invert<0>(cells, op.n, n_probe, u[i], v_lo,
                                          v_hi, op.xmin, op.dx, op.center);
    }
    th[iv + i] = v;
    v_lo = v;
  }
}

__global__ void __launch_bounds__(kThreads)
prior_transform_kernel(const __grid_constant__ PriorProgram prog,
                       const float* __restrict__ u, float* __restrict__ out,
                       long long B, int n_probe) {
  extern __shared__ float4 cells[];
  const long long b =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const bool live = b < B;
  const int C = prog.ncomp;
  const int D = prog.n_param * C;
  // the row, then the copy of the table, all in flight at once
  float th[kMaxVals];
  if (live) {
    const float* row = u + b * D;
    for (int k = 0; k < D; ++k) th[k] = row[k];
  }
  if (prog.cells != nullptr) {
    prior_tables::stage_rows<kThreads>(cells, prog.cells, 2 * prog.n_cells);
    __syncthreads();
  }
  if (!live) return;
  for (int o = 0; o < prog.n_op; ++o) {
    const PriorOp& op = prog.ops[o];
    float* r = th + op.row * C;
    switch (op.code) {
      case kPpf:
        for (int c = 0; c < C; ++c) r[c] = prior_tables::ppf(op.table, op.n,
                                                             r[c]);
        break;
      case kDuplicate:
        for (int c = 0; c < C; ++c) {
          r[c] = prior_tables::ppf(op.table, op.n, r[c]);
          th[op.row2 * C + c] = r[c];
        }
        break;
      case kConstant:
        for (int c = 0; c < C; ++c) r[c] = op.value;
        break;
      default:
        place(op, th, C, cells, n_probe);
        break;
    }
  }
  float* row = out + b * D;
  for (int k = 0; k < D; ++k) row[k] = th[k];
}

}  // namespace

// ``prog`` is the host's packed program (copied into the launch);
// ``u`` and ``out`` are [B, n_param * ncomp] float32, contiguous.
// Launches on ``stream`` of card ``device``.  Returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int prior_transform_launch(
    const prior_program::PriorProgram* prog, const float* u, float* out,
    long long B, int device, void* stream) {
  using namespace prior_program;
  if (B <= 0) return 0;
  // the launch goes to the tensors' card, whatever this library's
  // runtime last had current
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  const long long blocks = (B + kThreads - 1) / kThreads;
  const bool placed = prog->cells != nullptr;
  if (prog->n_op < 1 || prog->n_op > kMaxOps || prog->ncomp < 1 ||
      prog->n_param < 1 || prog->n_param * prog->ncomp > kMaxVals ||
      blocks > 0x7fffffffLL ||
      (placed && (prog->ncomp > kMaxPlaced || prog->n_cells < 2 ||
                  prog->n_cells > kMaxCells ||
                  reinterpret_cast<size_t>(prog->cells) % sizeof(float4))))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      placed ? 2 * sizeof(float4) * static_cast<size_t>(prog->n_cells) : 0;
  const int n_probe = placed ? prior_tables::probes(prog->n_cells) : 0;
  prior_transform_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      *prog, u, out, B, n_probe);
  return static_cast<int>(cudaGetLastError());
}

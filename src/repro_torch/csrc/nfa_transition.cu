// SEQ advance of every partial match (PM) of every pattern against one
// event — the CEP operator's per-event hot loop (engine step 4).
//
// Replaces: src/repro/kernels/nfa_transition.py::_nfa_kernel (one Pallas
// launch per pattern; the next state came out of a one-hot (tile, M) x
// (M,) matmul on the MXU because a gather is slow on the TPU's VPU).
//
// On the H100 a gather is cheap, so one launch covers all P patterns:
// grid (ceil(N / 256), P), one thread per PM slot.  The transition-column
// gather trans[p, state, class_p], the binding check and the completion
// flag are fused; the ragged tail (N not a multiple of 256) is masked
// here, so the host never pads.
//
// Bound: bytes.  Per PM it reads state, bind (4 B each) and active (1 B)
// and writes the next state (4 B) and the completion flag (1 B); the
// (P, M, C+1) table is a few hundred bytes and stays in L1/L2.  There is
// one integer compare-and-select per PM, so the arithmetic is negligible.
// At the main path's sizes (P·N ≤ a few thousand) one launch moves tens
// of kilobytes and launch latency, not bandwidth, sets the time; the
// design keeps it to one launch per event for the whole store.
#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void nfa_advance_kernel(
    const int32_t* __restrict__ state, const int32_t* __restrict__ bind,
    const uint8_t* __restrict__ active, const int32_t* __restrict__ trans,
    const int32_t* __restrict__ ev_class,
    const int32_t* __restrict__ ev_bind,
    const int32_t* __restrict__ final_state,
    const uint8_t* __restrict__ uses_binding, int n, int m, int c1,
    int32_t* __restrict__ new_state, uint8_t* __restrict__ completed) {
  const int p = blockIdx.y;
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= n) return;
  const int64_t at = static_cast<int64_t>(p) * n + j;
  const int32_t s = state[at];
  const bool live = active[at] != 0;
  const bool bind_ok = !uses_binding[p] || bind[at] == ev_bind[p];
  const int32_t nxt = repro::nfa_next(trans, p, s, ev_class[p], m, c1,
                                      live && bind_ok);
  const int32_t fin = final_state[p];
  new_state[at] = nxt;
  completed[at] = (live && nxt == fin && s != fin) ? 1 : 0;
}

}  // namespace

extern "C" int nfa_advance_launch(
    const void* state, const void* bind, const void* active,
    const void* trans, const void* ev_class, const void* ev_bind,
    const void* final_state, const void* uses_binding, int p, int n, int m,
    int c1, void* new_state, void* completed, void* stream) {
  if (p > 0 && n > 0) {
    dim3 grid((n + kThreads - 1) / kThreads, p);
    nfa_advance_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(state),
        static_cast<const int32_t*>(bind),
        static_cast<const uint8_t*>(active),
        static_cast<const int32_t*>(trans),
        static_cast<const int32_t*>(ev_class),
        static_cast<const int32_t*>(ev_bind),
        static_cast<const int32_t*>(final_state),
        static_cast<const uint8_t*>(uses_binding), n, m, c1,
        static_cast<int32_t*>(new_state), static_cast<uint8_t*>(completed));
  }
  return static_cast<int>(cudaGetLastError());
}

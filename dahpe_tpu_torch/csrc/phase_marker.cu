// Phase markers for device traces (sm_90a).
//
// Replaces no TPU kernel: the JAX package names the steps of its DA
// iteration in the XLA trace with named scopes, which a CUDA graph cannot
// keep (the host code that opens a scope runs once, at capture). A marker is
// an empty kernel launched on the iteration's stream where a phase begins;
// a kernel launched during a capture becomes a node of the graph, so every
// replay runs it again and the profiler's device trace shows it, in order,
// between the kernels of the phase before and those of the phase after.
//
// The phase is the kernel's template argument, a tag type, so the printed
// name alone says which phase begins: "void dahpe_phase_marker<
// dahpe_phase::step_a>()". `end` closes the iteration's last phase.
//
// What bounds it: nothing but the launch. One thread, no memory access; a
// marker costs its launch on the host (eager calls) and about a microsecond
// of the device's time.

#include <cuda_runtime.h>

namespace dahpe_phase {
struct producer {};
struct step_a {};
struct step_b {};
struct step_c {};
struct ema {};
struct end {};
}  // namespace dahpe_phase

template <class Phase>
__global__ void dahpe_phase_marker() {}

// The marker of phase `phase` (the index into profiling.MARKERS: producer,
// step_a, step_b, step_c, ema, end) on `stream`; the launch's CUDA error.
extern "C" int dahpe_phase_mark(int phase, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (phase) {
    case 0: dahpe_phase_marker<dahpe_phase::producer><<<1, 1, 0, s>>>(); break;
    case 1: dahpe_phase_marker<dahpe_phase::step_a><<<1, 1, 0, s>>>(); break;
    case 2: dahpe_phase_marker<dahpe_phase::step_b><<<1, 1, 0, s>>>(); break;
    case 3: dahpe_phase_marker<dahpe_phase::step_c><<<1, 1, 0, s>>>(); break;
    case 4: dahpe_phase_marker<dahpe_phase::ema><<<1, 1, 0, s>>>(); break;
    case 5: dahpe_phase_marker<dahpe_phase::end><<<1, 1, 0, s>>>(); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

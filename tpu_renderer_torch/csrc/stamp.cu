// The clock of the compiled frame's span timers (utils/profiling.py).
//
// Not a counterpart of a pallas_call site: while a program records its CUDA
// graph, every tr.<stage> span launches this kernel at its entry and at its
// exit, so each replay writes the device's %globaltimer (ns) at the stage's
// two bounds, in stream order: a stamp runs once the kernels before it have
// run. The slots lie in pinned host memory, which a kernel writes through
// the unified address space, so reading a replay's stamps copies nothing;
// the host reads them once the frame's outputs are complete.
//
// Why a kernel and not a timing event recorded into the graph: under a
// profiler (the only time the stamps are read) a replay's event nodes ran
// ahead of its kernels, as the graph launch began, while the kernels waited
// for the launch, so the first stage's timer held the launch's wait.
#include "common.cuh"

namespace {

__global__ void stamp_kernel(unsigned long long* __restrict__ slot) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    *slot = t;
}

}  // namespace

TR_EXPORT int tr_stamp(unsigned long long* stamps, int slot, void* stream) {
    stamp_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(stamps + slot);
    return (int)cudaGetLastError();
}

// Device stage stamps (utils/telemetry.py): one thread writes (sequence,
// stage code, %globaltimer) into a ring on the device at a cursor that
// lives on the device, so a stamp works wherever a CUDA graph's kernel node
// does, a conditional body included, and the host reads the ring only
// after the work it times.  The code is 2 * stage id + 1 at a stage's exit.
// One thread, three 8-byte stores: a few microseconds of launch, no more.

#include <cuda_runtime.h>

namespace {

__global__ void kde_stamp(long long* ring, unsigned long long* cursor, int capacity,
                          int code) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  const unsigned long long seq = atomicAdd(cursor, 1ull);
  long long* slot = ring + 3 * (seq % static_cast<unsigned long long>(capacity));
  slot[0] = static_cast<long long>(seq);
  slot[1] = code;
  slot[2] = static_cast<long long>(t);
}

}  // namespace

// ring: [capacity, 3] i64, cursor: one i64 (the stamps written), on the device
extern "C" int kde_stamp_launch(void* ring, void* cursor, int capacity, int code,
                                void* stream) {
  if (capacity < 1) return static_cast<int>(cudaErrorInvalidValue);
  kde_stamp<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(ring), static_cast<unsigned long long*>(cursor), capacity, code);
  return static_cast<int>(cudaGetLastError());
}

// the stamp kernel's address, by which csrc/graph.cu tells its nodes apart
extern "C" const void* kde_stamp_symbol() { return reinterpret_cast<const void*>(kde_stamp); }

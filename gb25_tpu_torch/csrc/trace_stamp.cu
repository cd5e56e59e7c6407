// The tracer's device stamps (utils/tracing.py): a one-thread kernel that
// reads the device clock (%globaltimer, nanoseconds) where a span opens or
// closes, on the span's stream, so that a stamp captured into a CUDA graph
// runs again at every replay.
//
// The table holds three rows of `slots` int64 each: start, total, count.
//   open:  start[slot] = now
//   close: total[slot] += now - start[slot]; count[slot] += 1
// Stream order runs the open before the close and one close before the
// next open of the slot, so no atomics are needed. Replays accumulate:
// one host read after any number of them gives each slot's device time.
// `log`, where not null, also receives `now` (a host-launched span's own
// open or close time, for the call-boundary reading); a captured stamp
// passes null, as its log cell could not change between replays.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__global__ void stamp_kernel(long long* table, int slots, int slot, int close, long long* log) {
  const long long now = global_ns();
  if (close) {
    table[slots + slot] += now - table[slot];
    table[2 * slots + slot] += 1;
  } else {
    table[slot] = now;
  }
  if (log != nullptr) *log = now;
}

}  // namespace

extern "C" const char* gb25_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int trace_stamp(long long* table, int slots, int slot, int close, long long* log,
                           void* stream) {
  if (table == nullptr || slot < 0 || slot >= slots)
    return static_cast<int>(cudaErrorInvalidValue);
  stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(table, slots, slot, close, log);
  return static_cast<int>(cudaGetLastError());
}

// A layer stamp of the train step: the device's clock at one point of the
// step's stream, written into the epoch scan's stamp table.
//
//   stamps[cursor[0] * ncols + col] = %globaltimer
//
// harp_tpu has no counterpart: XLA's profiler names the fused ops of its
// step. The port's stage step is one CUDA graph replayed a step at a time,
// and a trace of a replay lists its kernels by name only (mostly PyTorch's
// generic elementwise and gather kernels). A stamp captured into the graph
// at a layer boundary records, in every replay, when the device got there:
// the kernel runs once all work before it on the stream is done, reads the
// global nanosecond timer and writes it to the step's row, which the scan's
// device cursor selects. The host reads the table with the segment's one
// read (utils/profiling.py splits a row into the step's layers).
//
// One thread, 8 bytes written: the cost is the launch inside the graph,
// about a microsecond a stamp. Captured only while a profiler records.

#include <cuda_runtime.h>

namespace {

__global__ void stamp_kernel(long long* stamps, const long long* cursor, int ncols, int col) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  stamps[cursor[0] * ncols + col] = static_cast<long long>(t);
}

}  // namespace

// stamps (rows, ncols) int64 on the device; cursor (1,) int64, the row, in
// [0, rows); 0 <= col < ncols. Launched on `stream`, no synchronisation.
extern "C" int write_stamp(long long* stamps, const long long* cursor, int ncols, int col,
                           void* stream) {
  if (ncols <= 0 || col < 0 || col >= ncols) return (int)cudaErrorInvalidValue;
  stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(stamps, cursor, ncols, col);
  return (int)cudaGetLastError();
}

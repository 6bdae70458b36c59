// Dense compare pass of the scatter-join hash lookup, for Hopper (sm_90a).
//
// Replaces: genestrip_tpu/ops/pallas_lookup.py::dense_pass_pallas (Pallas
// body `_dense_kernel`), which the JAX package runs bit-identically as inline
// XLA inside genestrip_tpu/store/hash.py::lookup_join.
//
// What it computes. For every bucket b and scratch lane r: the first slot j
// in [0, 4) of row b with
//     h2[j] == sc_h[b, r]
//     (plane2[j] >>> vb) == sc_w[b, r]          (logical shift)
//     (plane2[j] & (2^vb - 1)) != 2^vb - 1      (slot not empty)
// and out[b, r] = (j << vb) | vidx, or -1 when no slot matches.
// rows is [NB, 8] int32: 4x h2 then 4x plane2 (rem2 | choice | vidx).
//
// What bounds it. Memory. Each bucket reads its 32-byte row and R lanes of
// two scratch planes and writes R words: 32 + 12 R bytes, about 1.3 GB a
// batch at NB = 2^24, R = 4, against a handful of integer compares.
//
// Design. One thread per bucket: the row comes in as two 16-byte vector
// loads, then the R lanes are compared against the 4 slots and R packed
// words are written. The row loads are coalesced: neighbouring threads read
// neighbouring 32-byte rows. The lane loads and stores are not: at a given r
// a warp's accesses are strided by 4 R bytes, so each instruction touches R
// times the sectors it uses and relies on L1/L2 to serve the rest on the
// following r. Indexing lanes as r * NB + b would make them coalesced too.
// The kernel allocates nothing and launches on the caller's stream.
//
// Note. This pass streams the whole bucket table for every batch, whatever
// the number of queries: a TPU-shaped choice (row gathers were slow there,
// genestrip_tpu/store/hash.py:260-285). Whether lookup_hash's two random
// row gathers serve this card better is a later, measured decision.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void dense_pass_kernel(const int4* __restrict__ rows,
                                  const int* __restrict__ sc_h,
                                  const int* __restrict__ sc_w,
                                  int* __restrict__ out,
                                  long long nb, int r_lanes, int vb) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= nb) return;
  const int4 h = __ldg(rows + 2 * b);
  const int4 p = __ldg(rows + 2 * b + 1);
  const int hs[4] = {h.x, h.y, h.z, h.w};
  const unsigned ps[4] = {(unsigned)p.x, (unsigned)p.y, (unsigned)p.z,
                          (unsigned)p.w};
  const unsigned empty = (1u << vb) - 1u;
  const long long base = b * r_lanes;
  for (int r = 0; r < r_lanes; ++r) {
    const int qh = __ldg(sc_h + base + r);
    const int qw = __ldg(sc_w + base + r);
    int res = -1;
    // descending j: the last assignment, the smallest matching j, wins
#pragma unroll
    for (int j = 3; j >= 0; --j) {
      const unsigned v = ps[j] & empty;
      const bool eq = (hs[j] == qh) && ((int)(ps[j] >> vb) == qw) &&
                      (v != empty);
      res = eq ? (int)(((unsigned)j << vb) | v) : res;
    }
    out[base + r] = res;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. Pointers are device pointers of
// contiguous int32 tensors (rows 16-byte aligned); stream is a cudaStream_t.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int gs_dense_pass(const void* rows, const void* sc_h,
                             const void* sc_w, void* out, long long nb,
                             int r_lanes, int vb, void* stream) {
  if (nb <= 0 || r_lanes <= 0) return 0;
  const int threads = 256;
  const long long blocks = (nb + threads - 1) / threads;
  dense_pass_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int4*)rows, (const int*)sc_h, (const int*)sc_w, (int*)out, nb,
      r_lanes, vb);
  return (int)cudaGetLastError();
}

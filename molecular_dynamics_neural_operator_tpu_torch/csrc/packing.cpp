// Native batch packing for contact-map graphs: the port's copy of the
// JAX package's csrc/packing.cpp, a host helper (no TPU kernel).
//
// The host-side hot loop of the input pipeline: per-frame ragged COO edge
// lists (CSR-packed: concatenated edges + offsets) into the static shapes
// a batch takes, dense (B, R, R) adjacency masks or padded (B, 2, E) edge
// lists + validity masks, and the sliding-window gather. Gives the same
// arrays as the numpy path of data/windows.py, without its per-batch index
// arrays. Plain C ABI for ctypes; built with the host compiler on first use
// by data/packing.py (g++ -O3 -fPIC -shared -std=c++17) into the package's
// build/ directory, apart from the CUDA kernels (ops/cuda/_build.py never
// hashes this file).

#include <cstdint>
#include <cstring>

extern "C" {

// Densify: for each batch item b with frame index idx[b], set
// out[b, src, dst] = 1 for every stored edge of that frame.
// edges_flat: (2, total_edges) int32 row-major [all srcs; all dsts]
// offsets:    (num_frames + 1) int64 prefix sums
// idx:        (batch) int64 frame indices
// out:        (batch, r, r) float32, pre-zeroed by caller or zeroed here
void pack_dense_batch(
    const int32_t* edges_flat,
    int64_t total_edges,
    const int64_t* offsets,
    const int64_t* idx,
    int64_t batch,
    int64_t r,
    float* out) {
  const int32_t* srcs = edges_flat;
  const int32_t* dsts = edges_flat + total_edges;
  const int64_t rr = r * r;
  std::memset(out, 0, sizeof(float) * batch * rr);
  for (int64_t b = 0; b < batch; ++b) {
    float* frame = out + b * rr;
    const int64_t lo = offsets[idx[b]];
    const int64_t hi = offsets[idx[b] + 1];
    for (int64_t e = lo; e < hi; ++e) {
      frame[static_cast<int64_t>(srcs[e]) * r + dsts[e]] = 1.0f;
    }
  }
}

// Padded edge lists: out_edges (batch, 2, e_max) int32, out_mask
// (batch, e_max) float32. Returns the max real edge count seen (so the
// caller can detect capacity overflow: result > e_max).
int64_t pack_padded_batch(
    const int32_t* edges_flat,
    int64_t total_edges,
    const int64_t* offsets,
    const int64_t* idx,
    int64_t batch,
    int64_t e_max,
    int32_t* out_edges,
    float* out_mask) {
  const int32_t* srcs = edges_flat;
  const int32_t* dsts = edges_flat + total_edges;
  std::memset(out_edges, 0, sizeof(int32_t) * batch * 2 * e_max);
  std::memset(out_mask, 0, sizeof(float) * batch * e_max);
  int64_t max_count = 0;
  for (int64_t b = 0; b < batch; ++b) {
    const int64_t lo = offsets[idx[b]];
    const int64_t hi = offsets[idx[b] + 1];
    int64_t n = hi - lo;
    if (n > max_count) max_count = n;
    if (n > e_max) n = e_max;
    int32_t* eb = out_edges + b * 2 * e_max;
    float* mb = out_mask + b * e_max;
    std::memcpy(eb, srcs + lo, sizeof(int32_t) * n);
    std::memcpy(eb + e_max, dsts + lo, sizeof(int32_t) * n);
    for (int64_t e = 0; e < n; ++e) mb[e] = 1.0f;
  }
  return max_count;
}

// Sliding-window gather: out[b, t] = positions[idx[b] + t] for t in
// [0, window). positions: (num_frames, r, 3) float32 contiguous.
void gather_windows(
    const float* positions,
    int64_t r,
    const int64_t* idx,
    int64_t batch,
    int64_t window,
    float* out) {
  const int64_t frame_sz = r * 3;
  for (int64_t b = 0; b < batch; ++b) {
    std::memcpy(out + b * window * frame_sz,
                positions + idx[b] * frame_sz,
                sizeof(float) * window * frame_sz);
  }
}

}  // extern "C"

// Sequence-packing hot loop (C ABI; loaded via ctypes from ops/packing.py).
//
// Variable-length sequences are packed into fixed-length rows ("sample packing") so a
// train step sees one shape and no compute goes to padding. The bin assignment + scatter
// is pure host work in the data path — for web-scale corpora it runs per batch on the
// dataloader thread, so it is implemented here natively with a pure-Python version kept
// behavior-identical (tests assert C++ == Python on random corpora).
//
// Build: g++ -O3 -shared -fPIC -pthread packing.cpp -o libpacking.so   (native/__init__.py
// does this at first use, into build/native/ at the repository root).

#include <cstdint>
#include <vector>

extern "C" {

// First-fit packing of n_seq sequences into rows of `capacity` tokens.
//
// tokens:   concatenated int32 token ids for all sequences
// offsets:  n_seq+1 prefix offsets into `tokens` (sequence i = [offsets[i], offsets[i+1]))
// out_*:    preallocated [max_bins * capacity] int32, zero-filled by the caller
//           (tokens: pad 0; segments: 0 = padding, first real segment = 1; positions: 0)
// Returns the number of bins used, or -1 if max_bins was insufficient or a sequence
// exceeds capacity.
long long pack_sequences_ffit(const int32_t* tokens, const int64_t* offsets, int64_t n_seq,
                              int64_t capacity, int32_t* out_tokens, int32_t* out_segments,
                              int32_t* out_positions, int64_t max_bins) {
  std::vector<int64_t> used;     // tokens consumed per bin
  std::vector<int32_t> n_segs;   // segments placed per bin
  used.reserve(256);
  n_segs.reserve(256);
  for (int64_t i = 0; i < n_seq; ++i) {
    const int64_t len = offsets[i + 1] - offsets[i];
    if (len > capacity || len < 0) return -1;
    if (len == 0) continue;
    // First-fit: the earliest bin with room. O(n_seq * n_bins) worst case; bins fill and
    // stop matching quickly for natural length distributions.
    int64_t bin = -1;
    for (int64_t b = 0; b < (int64_t)used.size(); ++b) {
      if (used[b] + len <= capacity) { bin = b; break; }
    }
    if (bin < 0) {
      if ((int64_t)used.size() >= max_bins) return -1;
      used.push_back(0);
      n_segs.push_back(0);
      bin = (int64_t)used.size() - 1;
    }
    const int64_t start = bin * capacity + used[bin];
    const int32_t seg = ++n_segs[bin];
    const int32_t* src = tokens + offsets[i];
    for (int64_t t = 0; t < len; ++t) {
      out_tokens[start + t] = src[t];
      out_segments[start + t] = seg;
      out_positions[start + t] = (int32_t)t;
    }
    used[bin] += len;
  }
  return (long long)used.size();
}

}  // extern "C"

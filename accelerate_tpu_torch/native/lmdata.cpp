// Indexed LM dataset hot loops (C ABI; loaded via ctypes from lm_dataset.py).
//
// The Megatron-indexed-dataset analog for this framework: a pretraining corpus is one
// flat memmapped token array; a training sample is a [seq_len+1] window at a shuffled
// offset. The shuffle and the batch gather are pure host work on the dataloader thread —
// implemented natively (deterministic RNG, multithreaded gather) with a behavior-identical
// pure-Python fallback (tests assert C++ == Python).
//
// Build: g++ -O3 -shared -fPIC -pthread lmdata.cpp -o liblmdata.so   (native/__init__.py
// does this at first use, into build/native/ at the repository root).

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// splitmix64: tiny, seedable, platform-stable. Python fallback mirrors it exactly.
inline uint64_t splitmix64(uint64_t& state) {
  uint64_t z = (state += 0x9e3779b97f4a7c15ULL);
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
  return z ^ (z >> 31);
}

}  // namespace

extern "C" {

// Deterministic Fisher-Yates over idx[0..n) seeded by `seed` (epoch folded in by caller).
void lm_shuffle(int64_t* idx, int64_t n, uint64_t seed) {
  uint64_t state = seed;
  for (int64_t i = n - 1; i > 0; --i) {
    const uint64_t j = splitmix64(state) % static_cast<uint64_t>(i + 1);
    const int64_t tmp = idx[i];
    idx[i] = idx[j];
    idx[j] = tmp;
  }
}

// Gather `batch` windows of `width` tokens each: out[b] = tokens[starts[b] .. +width).
// Multithreaded memcpy; caller guarantees starts[b] + width <= n_tokens.
// Returns 0, or -1 on a bounds violation (nothing partially written in that case).
int64_t lm_gather(const int32_t* tokens, int64_t n_tokens, const int64_t* starts,
                  int64_t batch, int64_t width, int32_t* out) {
  for (int64_t b = 0; b < batch; ++b) {
    if (starts[b] < 0 || starts[b] + width > n_tokens) return -1;
  }
  const int64_t bytes = width * static_cast<int64_t>(sizeof(int32_t));
  // Thread only when the copy is big enough to amortize spawn/join (~10s of us): for
  // small batches or narrow windows the single-thread memcpy loop wins outright.
  constexpr int64_t kMinBytesForThreads = 1 << 20;  // 1 MiB total
  const unsigned hw = std::thread::hardware_concurrency();
  const int64_t n_threads =
      (batch >= 8 && hw > 1 && batch * bytes >= kMinBytesForThreads)
          ? std::min<int64_t>(batch, hw)
          : 1;
  if (n_threads == 1) {
    for (int64_t b = 0; b < batch; ++b) {
      std::memcpy(out + b * width, tokens + starts[b], bytes);
    }
    return 0;
  }
  std::vector<std::thread> workers;
  workers.reserve(n_threads);
  for (int64_t t = 0; t < n_threads; ++t) {
    workers.emplace_back([=]() {
      for (int64_t b = t; b < batch; b += n_threads) {
        std::memcpy(out + b * width, tokens + starts[b], bytes);
      }
    });
  }
  for (auto& w : workers) w.join();
  return 0;
}

}  // extern "C"

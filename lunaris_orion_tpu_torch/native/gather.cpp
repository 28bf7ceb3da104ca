// Native batch gatherer for the sprite data pipeline (the port's copy of
// lunaris_orion_tpu/native/gather.cpp, with the same C interface).
//
// Batch assembly is a single C++ call over the memory-mapped uint8 shards:
// a binary search for each row's shard, a memcpy per row, no Python in
// the inner loop. uint8 stays uint8: the train step normalizes on the
// device.
//
// Built with: g++ -O3 -shared -fPIC -std=c++17 -o libgather.so gather.cpp
// Bound via ctypes (lunaris_orion_tpu_torch/data/native.py), which builds
// it at first use.

#include <cstdint>
#include <cstring>
#include <algorithm>

extern "C" {

// Gather rows from multiple shards into `out`.
//   shard_ptrs:  base pointer of each shard's data (n_shards)
//   cum:         cumulative row counts, length n_shards+1 (cum[0]=0)
//   indices:     global row ids to gather (n_idx)
//   item_bytes:  bytes per row (H*W*C for uint8 sprites)
//   out:         n_idx * item_bytes destination
//   n_threads:   kept for the JAX package's interface; the rows are
//                copied on the calling thread
void gather_u8(const uint8_t** shard_ptrs, const int64_t* cum,
               int64_t n_shards, const int64_t* indices, int64_t n_idx,
               int64_t item_bytes, uint8_t* out, int64_t /*n_threads*/) {
  for (int64_t i = 0; i < n_idx; ++i) {
    const int64_t gid = indices[i];
    // binary search for the owning shard
    const int64_t* it = std::upper_bound(cum, cum + n_shards + 1, gid);
    const int64_t sid = (it - cum) - 1;
    const int64_t local = gid - cum[sid];
    std::memcpy(out + i * item_bytes, shard_ptrs[sid] + local * item_bytes,
                static_cast<size_t>(item_bytes));
  }
}

// Fisher-Yates shuffle of an index array with SplitMix64 — the loader's
// per-epoch permutation without numpy allocation churn.
void shuffle_indices(int64_t* indices, int64_t n, uint64_t seed) {
  auto next = [&seed]() {
    seed += 0x9E3779B97F4A7C15ull;
    uint64_t z = seed;
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
    return z ^ (z >> 31);
  };
  for (int64_t i = n - 1; i > 0; --i) {
    const int64_t j = static_cast<int64_t>(next() % static_cast<uint64_t>(i + 1));
    std::swap(indices[i], indices[j]);
  }
}

}  // extern "C"

// Native greedy token packer (C++), the hot loop of the v2 calibration
// dataloader: documents' token ids, each followed by the separator ids,
// fill a buffer past max_seqlen; its first max_seqlen ids are one row and
// the rest is dropped; repeat.  The last document is never packed, and a
// final partial row is dropped (fixed-shape batches hold no ragged rows).
//
// C ABI (ctypes):
//   pack_greedy(tokens, offsets, n_docs, sep, sep_len, max_seqlen,
//               out, max_rows) -> n_rows
// tokens: all docs' token ids concatenated; offsets: n_docs+1 prefix sums.
// out: preallocated (max_rows * max_seqlen) int32 buffer, filled row-major.

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

int64_t pack_greedy(const int32_t* tokens, const int64_t* offsets,
                    int64_t n_docs, const int32_t* sep, int64_t sep_len,
                    int64_t max_seqlen, int32_t* out, int64_t max_rows) {
  std::vector<int32_t> buffer;
  buffer.reserve(2 * static_cast<size_t>(max_seqlen));
  int64_t n_rows = 0;
  int64_t idx = 0;
  while (idx < n_docs - 1 && n_rows < max_rows) {
    while (buffer.size() <= static_cast<size_t>(max_seqlen) &&
           idx < n_docs - 1) {
      const int64_t begin = offsets[idx];
      const int64_t end = offsets[idx + 1];
      buffer.insert(buffer.end(), tokens + begin, tokens + end);
      buffer.insert(buffer.end(), sep, sep + sep_len);
      ++idx;
    }
    if (buffer.size() >= static_cast<size_t>(max_seqlen)) {
      std::memcpy(out + n_rows * max_seqlen, buffer.data(),
                  static_cast<size_t>(max_seqlen) * sizeof(int32_t));
      ++n_rows;
    }
    buffer.clear();
  }
  return n_rows;
}

// Uniformly shuffle row indices (Fisher-Yates) with a splitmix64 PRNG seeded
// by ``seed``: the image pipeline's epoch shuffle.
void shuffle_indices(int64_t* indices, int64_t n, uint64_t seed) {
  auto next = [&seed]() {
    seed += 0x9E3779B97f4A7C15ULL;
    uint64_t z = seed;
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
    return z ^ (z >> 31);
  };
  for (int64_t i = n - 1; i > 0; --i) {
    int64_t j = static_cast<int64_t>(next() % static_cast<uint64_t>(i + 1));
    int64_t tmp = indices[i];
    indices[i] = indices[j];
    indices[j] = tmp;
  }
}

}  // extern "C"

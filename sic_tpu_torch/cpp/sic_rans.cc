// Native entropy-coding runtime (the PyTorch port's copy of the JAX
// package's coder; both build from identical sources and write identical
// streams).
//
// A from-scratch C++17 implementation of the byte-aligned rANS coder used by
// the .c2df bitstream format.  Wire-compatible with the reference coder
// (reference: src/cpp/rans/rans.cpp, src/cpp/py_rans/py_rans.cpp):
//   * 16-bit probability precision, byte-aligned renormalisation, L = 2^23
//   * per-symbol CDF selected by an int16 index; index < 0 skips the symbol
//   * escape coding for out-of-range symbols in 2-bit bypass chunks
//   * multi-substream container: 1 flag byte ((nparts-1)<<4 | u16-header bit),
//     per-substream byte sizes for all but the last part, then the parts.
//
// Exposed through a plain C ABI consumed by ctypes (no pybind11).  Substream
// encode/decode fan out across std::thread workers.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <numeric>
#include <thread>
#include <vector>

namespace {

constexpr uint32_t kProbBits = 16;
constexpr uint32_t kRansL = 1u << 23;  // renormalisation lower bound
constexpr uint32_t kBypassBits = 2;
constexpr uint32_t kBypassMax = (1u << kBypassBits) - 1;

using RansState = uint32_t;

// A buffered symbol: range > 0 encodes a CDF slot, range == 0 encodes
// kBypassBits raw bits whose value is in `start`.
struct Sym {
  uint16_t start;
  uint16_t range;
};

inline void put_symbol(RansState& x, std::vector<uint8_t>& out, uint32_t start,
                       uint32_t freq) {
  // Renormalise: with 16-bit precision and byte emission the threshold is
  // ((L >> 16) << 8) * freq == freq << 15.
  const uint32_t x_max = freq << 15;
  while (x >= x_max) {
    out.push_back(static_cast<uint8_t>(x & 0xff));
    x >>= 8;
  }
  x = ((x / freq) << kProbBits) + (x % freq) + start;
}

inline void put_raw_bits(RansState& x, std::vector<uint8_t>& out, uint32_t val,
                         uint32_t nbits) {
  const uint32_t freq = 1u << (kProbBits - nbits);
  const uint32_t x_max = freq << 15;
  while (x >= x_max) {
    out.push_back(static_cast<uint8_t>(x & 0xff));
    x >>= 8;
  }
  x = (x << nbits) | val;
}

struct CdfGroup {
  // Flattened (start, freq) pairs per CDF row, plus raw rows for decode.
  std::vector<std::vector<Sym>> enc_rows;
  std::vector<std::vector<int32_t>> rows;
  std::vector<int32_t> sizes;
  std::vector<int32_t> offsets;
};

class PartEncoder {
 public:
  void encode(const int16_t* symbols, const int16_t* indexes, int64_t n,
              const CdfGroup& g) {
    syms_.reserve(syms_.size() + static_cast<size_t>(n) * 3 / 2);
    for (int64_t i = 0; i < n; ++i) {
      const int32_t cdf_idx = indexes[i];
      if (cdf_idx < 0) continue;  // skipped symbol (zero-scale position)
      const int32_t max_value = g.sizes[cdf_idx] - 2;
      int32_t value = symbols[i] - g.offsets[cdf_idx];

      uint32_t raw_val = 0;
      if (value < 0) {
        raw_val = static_cast<uint32_t>(-2 * value - 1);
        value = max_value;
      } else if (value >= max_value) {
        raw_val = static_cast<uint32_t>(2 * (value - max_value));
        value = max_value;
      }
      syms_.push_back(g.enc_rows[cdf_idx][value]);

      if (value == max_value) {
        // Escape: count 2-bit chunks needed for raw_val, emit the count in
        // saturating kBypassMax steps, then the chunks LSB-first.
        int32_t n_bypass = 0;
        while ((raw_val >> (n_bypass * kBypassBits)) != 0) ++n_bypass;
        int32_t rem = n_bypass;
        while (rem >= static_cast<int32_t>(kBypassMax)) {
          syms_.push_back({static_cast<uint16_t>(kBypassMax), 0});
          rem -= kBypassMax;
        }
        syms_.push_back({static_cast<uint16_t>(rem), 0});
        for (int32_t j = 0; j < n_bypass; ++j) {
          const uint32_t chunk = (raw_val >> (j * kBypassBits)) & kBypassMax;
          syms_.push_back({static_cast<uint16_t>(chunk), 0});
        }
      }
    }
  }

  void flush() {
    RansState x = kRansL;
    std::vector<uint8_t> rev;  // bytes in emission (reverse-stream) order
    rev.reserve(syms_.size());
    for (auto it = syms_.rbegin(); it != syms_.rend(); ++it) {
      if (it->range != 0) {
        put_symbol(x, rev, it->start, it->range);
      } else {
        put_raw_bits(x, rev, it->start, kBypassBits);
      }
    }
    stream_.resize(rev.size() + 4);
    // Final state goes first in the byte stream, little-endian.
    stream_[0] = static_cast<uint8_t>(x >> 0);
    stream_[1] = static_cast<uint8_t>(x >> 8);
    stream_[2] = static_cast<uint8_t>(x >> 16);
    stream_[3] = static_cast<uint8_t>(x >> 24);
    for (size_t i = 0; i < rev.size(); ++i) {
      stream_[4 + i] = rev[rev.size() - 1 - i];
    }
  }

  void reset() {
    syms_.clear();
    stream_.clear();
  }

  const std::vector<uint8_t>& stream() const { return stream_; }

 private:
  std::vector<Sym> syms_;
  std::vector<uint8_t> stream_;
};

class PartDecoder {
 public:
  // Returns false on malformed (too-short) substreams.
  bool set_stream(std::vector<uint8_t> data) {
    data_ = std::move(data);
    if (data_.size() < 4) {
      data_.clear();
      pos_ = 0;
      x_ = 0;
      return false;
    }
    x_ = static_cast<uint32_t>(data_[0]) | (static_cast<uint32_t>(data_[1]) << 8) |
         (static_cast<uint32_t>(data_[2]) << 16) |
         (static_cast<uint32_t>(data_[3]) << 24);
    pos_ = 4;
    return true;
  }

  void decode(const int16_t* indexes, int64_t n, const CdfGroup& g,
              int16_t* out) {
    for (int64_t i = 0; i < n; ++i) {
      const int32_t cdf_idx = indexes[i];
      if (cdf_idx < 0) {
        out[i] = 0;
        continue;
      }
      const int32_t* cdf = g.rows[cdf_idx].data();
      const int32_t size = g.sizes[cdf_idx];
      const int32_t max_value = size - 2;
      const uint32_t cum = x_ & ((1u << kProbBits) - 1);

      // Locate s with cdf[s] <= cum < cdf[s+1] (rows are strictly increasing).
      int32_t s = 0;
      while (s + 1 < size && static_cast<uint32_t>(cdf[s + 1]) <= cum) ++s;

      advance(static_cast<uint32_t>(cdf[s]),
              static_cast<uint32_t>(cdf[s + 1] - cdf[s]));

      int32_t value = s;
      if (value == max_value) {
        uint32_t val = get_raw_bits(kBypassBits);
        uint32_t n_bypass = val;
        while (val == kBypassMax) {
          val = get_raw_bits(kBypassBits);
          n_bypass += val;
        }
        uint32_t raw_val = 0;
        for (uint32_t j = 0; j < n_bypass; ++j) {
          raw_val |= get_raw_bits(kBypassBits) << (j * kBypassBits);
        }
        value = static_cast<int32_t>(raw_val >> 1);
        if (raw_val & 1) {
          value = -value - 1;
        } else {
          value += max_value;
        }
      }
      out[i] = static_cast<int16_t>(value + g.offsets[cdf_idx]);
    }
  }

 private:
  void advance(uint32_t start, uint32_t freq) {
    const uint32_t mask = (1u << kProbBits) - 1;
    uint32_t x = x_;
    x = freq * (x >> kProbBits) + (x & mask) - start;
    while (x < kRansL && pos_ < data_.size()) {
      x = (x << 8) | data_[pos_++];
    }
    x_ = x;
  }

  uint32_t get_raw_bits(uint32_t nbits) {
    const uint32_t val = x_ & ((1u << nbits) - 1);
    uint32_t x = x_ >> nbits;
    if (x < kRansL && pos_ < data_.size()) {
      x = (x << 8) | data_[pos_++];
    }
    x_ = x;
    return val;
  }

  std::vector<uint8_t> data_;
  size_t pos_ = 0;
  RansState x_ = 0;
};

CdfGroup make_group(const int32_t* cdfs, int32_t ncdf, int32_t width,
                    const int32_t* sizes, const int32_t* offsets) {
  CdfGroup g;
  g.rows.resize(ncdf);
  g.enc_rows.resize(ncdf);
  g.sizes.assign(sizes, sizes + ncdf);
  g.offsets.assign(offsets, offsets + ncdf);
  for (int32_t i = 0; i < ncdf; ++i) {
    g.rows[i].assign(cdfs + static_cast<int64_t>(i) * width,
                     cdfs + static_cast<int64_t>(i + 1) * width);
    auto& row = g.enc_rows[i];
    row.resize(width > 0 ? width - 1 : 0);
    for (int32_t j = 0; j + 1 < width; ++j) {
      row[j] = Sym{static_cast<uint16_t>(g.rows[i][j]),
                   static_cast<uint16_t>(g.rows[i][j + 1] - g.rows[i][j])};
    }
  }
  return g;
}

void parallel_for_parts(int nparts, const std::function<void(int)>& fn) {
  if (nparts <= 1) {
    if (nparts == 1) fn(0);
    return;
  }
  std::vector<std::thread> ts;
  ts.reserve(nparts);
  for (int i = 0; i < nparts; ++i) ts.emplace_back(fn, i);
  for (auto& t : ts) t.join();
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

struct SicEncoder {
  std::vector<PartEncoder> parts;
  std::vector<CdfGroup> groups;
  std::vector<uint8_t> framed;
};

struct SicDecoder {
  std::vector<PartDecoder> parts;
  std::vector<CdfGroup> groups;
};

extern "C" {

SicEncoder* sic_enc_new(int stream_part) {
  auto* e = new SicEncoder();
  e->parts.resize(stream_part > 0 ? stream_part : 1);
  return e;
}

void sic_enc_free(SicEncoder* e) { delete e; }

int sic_enc_add_cdf(SicEncoder* e, const int32_t* cdfs, int32_t ncdf,
                    int32_t width, const int32_t* sizes,
                    const int32_t* offsets) {
  e->groups.push_back(make_group(cdfs, ncdf, width, sizes, offsets));
  return static_cast<int>(e->groups.size()) - 1;
}

void sic_enc_encode_with_indexes(SicEncoder* e, const int16_t* symbols,
                                 const int16_t* indexes, int64_t n,
                                 int group) {
  const int nparts = static_cast<int>(e->parts.size());
  const int64_t each = n / nparts;
  const CdfGroup& g = e->groups[group];
  parallel_for_parts(nparts, [&](int i) {
    const int64_t off = each * i;
    const int64_t cnt = (i == nparts - 1) ? (n - off) : each;
    e->parts[i].encode(symbols + off, indexes + off, cnt, g);
  });
}

void sic_enc_flush(SicEncoder* e) {
  const int nparts = static_cast<int>(e->parts.size());
  parallel_for_parts(nparts, [&](int i) { e->parts[i].flush(); });

  // Frame the substreams (reference: src/cpp/py_rans/py_rans.cpp:91-136).
  size_t maximum = 0, total = 0;
  for (int i = 0; i < nparts; ++i) {
    const size_t nbytes = e->parts[i].stream().size();
    if (i < nparts - 1 && nbytes > maximum) maximum = nbytes;
    total += nbytes;
  }
  const int per_header = maximum > 65535 ? 4 : 2;
  size_t overhead = 1;
  if (nparts > 1) overhead += static_cast<size_t>(nparts - 1) * per_header;

  e->framed.assign(total + overhead, 0);
  e->framed[0] = static_cast<uint8_t>(((nparts - 1) << 4) +
                                      (per_header == 2 ? 1 : 0));
  for (int i = 0; i < nparts - 1; ++i) {
    const uint32_t sz = static_cast<uint32_t>(e->parts[i].stream().size());
    if (per_header == 2) {
      const uint16_t s16 = static_cast<uint16_t>(sz);
      std::memcpy(e->framed.data() + 1 + 2 * i, &s16, 2);
    } else {
      std::memcpy(e->framed.data() + 1 + 4 * i, &sz, 4);
    }
  }
  size_t off = overhead;
  for (int i = 0; i < nparts; ++i) {
    const auto& s = e->parts[i].stream();
    std::memcpy(e->framed.data() + off, s.data(), s.size());
    off += s.size();
  }
}

int64_t sic_enc_stream_size(SicEncoder* e) {
  return static_cast<int64_t>(e->framed.size());
}

void sic_enc_get_stream(SicEncoder* e, uint8_t* out) {
  std::memcpy(out, e->framed.data(), e->framed.size());
}

void sic_enc_reset(SicEncoder* e) {
  for (auto& p : e->parts) p.reset();
  e->framed.clear();
}

SicDecoder* sic_dec_new(int stream_part) {
  auto* d = new SicDecoder();
  d->parts.resize(stream_part > 0 ? stream_part : 1);
  return d;
}

void sic_dec_free(SicDecoder* d) { delete d; }

int sic_dec_add_cdf(SicDecoder* d, const int32_t* cdfs, int32_t ncdf,
                    int32_t width, const int32_t* sizes,
                    const int32_t* offsets) {
  d->groups.push_back(make_group(cdfs, ncdf, width, sizes, offsets));
  return static_cast<int>(d->groups.size()) - 1;
}

int sic_dec_set_stream(SicDecoder* d, const uint8_t* data, int64_t n) {
  // Defensive parse: this entry point sees untrusted bytes (service-side
  // .c2df uploads).  Every header read and substream slice is bounds-
  // checked; any inconsistency returns -1 (python raises ValueError).
  if (n < 1) return -1;
  const uint8_t flag = data[0];
  const int nstreams = (flag >> 4) + 1;
  const int per_header = ((flag & 0x0f) == 1) ? 2 : 4;
  if (nstreams != static_cast<int>(d->parts.size())) {
    d->parts.assign(nstreams, PartDecoder());
  }
  std::vector<uint32_t> sizes;
  int64_t off = 1;
  int64_t total = 0;
  if (off + static_cast<int64_t>(nstreams - 1) * per_header > n) return -1;
  for (int i = 0; i < nstreams - 1; ++i) {
    uint32_t sz = 0;
    if (per_header == 2) {
      uint16_t s16;
      std::memcpy(&s16, data + off, 2);
      off += 2;
      sz = s16;
    } else {
      std::memcpy(&sz, data + off, 4);
      off += 4;
    }
    sizes.push_back(sz);
    total += sz;
  }
  if (off + total > n) return -1;
  sizes.push_back(static_cast<uint32_t>(n - off - total));
  for (int i = 0; i < nstreams; ++i) {
    if (off + static_cast<int64_t>(sizes[i]) > n) return -1;
    if (!d->parts[i].set_stream(
            std::vector<uint8_t>(data + off, data + off + sizes[i]))) {
      return -1;
    }
    off += sizes[i];
  }
  return nstreams;
}

void sic_dec_decode_stream(SicDecoder* d, const int16_t* indexes, int64_t n,
                           int group, int16_t* out) {
  const int nparts = static_cast<int>(d->parts.size());
  const int64_t each = n / nparts;
  const CdfGroup& g = d->groups[group];
  parallel_for_parts(nparts, [&](int i) {
    const int64_t off = each * i;
    const int64_t cnt = (i == nparts - 1) ? (n - off) : each;
    d->parts[i].decode(indexes + off, cnt, g, out + off);
  });
}

// ---------------------------------------------------------------------------
// PMF -> quantized CDF (integer repair identical to the reference;
// reference: src/cpp/ops/ops.cpp:24-82).  Input doubles are narrowed to float
// first to match the reference's vector<float> signature.
// ---------------------------------------------------------------------------
void sic_pmf_to_quantized_cdf(const double* pmf_in, int32_t n,
                              int32_t precision, uint32_t* cdf /* n+1 */) {
  std::vector<uint32_t> c(n + 1);
  c[0] = 0;
  for (int32_t i = 0; i < n; ++i) {
    const float p = static_cast<float>(pmf_in[i]);
    c[i + 1] = static_cast<uint32_t>(
        std::round(p * (1 << precision)) + 0.5);
  }
  const uint32_t total = std::accumulate(c.begin(), c.end(), 0u);
  for (auto& v : c) {
    v = static_cast<uint32_t>(((1ull << precision) * v) / total);
  }
  std::partial_sum(c.begin(), c.end(), c.begin());
  c.back() = 1u << precision;

  for (int32_t i = 0; i < n; ++i) {
    if (c[i] == c[i + 1]) {
      // Zero-frequency slot: steal one count from the lowest-frequency
      // stealable symbol and shift the intermediate boundaries.
      uint32_t best_freq = ~0u;
      int32_t best_steal = -1;
      for (int32_t j = 0; j < n; ++j) {
        const uint32_t freq = c[j + 1] - c[j];
        if (freq > 1 && freq < best_freq) {
          best_freq = freq;
          best_steal = j;
        }
      }
      if (best_steal < i) {
        for (int32_t j = best_steal + 1; j <= i; ++j) c[j]--;
      } else {
        for (int32_t j = i + 1; j <= best_steal; ++j) c[j]++;
      }
    }
  }
  std::memcpy(cdf, c.data(), sizeof(uint32_t) * (n + 1));
}

}  // extern "C"

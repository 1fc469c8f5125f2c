// Native greedy worst-case-mIoU search.
//
// Same algorithm as robseg_tpu/attacks/worst_case.py::worst_case_miou
// (behavioral target: tools/worse_only.py:181-349 of the reference):
// start from attack 0 for every image; for up to n_rounds shuffled passes,
// try every attack per image and accept when the resulting global mIoU
// drops; stop when a full round improves by <= tol.
//
// The Python loop costs O(rounds * N * A * K) interpreted operations —
// minutes for ADE20K-sized inputs; this runs the identical double-precision
// arithmetic natively. The shuffle uses std::mt19937 Fisher-Yates (the
// Python engine uses random.Random — trajectories can differ, minima agree;
// both are deterministic given their seed).
//
// Build: g++ -O3 -shared -fPIC -o libworstcase.so worst_case.cpp

#include <cstdint>
#include <random>
#include <vector>

extern "C" {

// ints/unis: [A, N, K] row-major doubles. selected: out [N] int64.
// Returns the final worst-case mIoU.
double worst_case_miou(const double* ints, const double* unis,
                       int64_t A, int64_t N, int64_t K,
                       int64_t n_rounds, double tol, uint64_t seed,
                       int64_t* selected) {
  std::vector<double> run_int(K, 0.0), run_uni(K, 0.0);
  std::vector<int64_t> order(N);
  for (int64_t i = 0; i < N; ++i) {
    selected[i] = 0;
    order[i] = i;
  }
  auto at = [&](const double* base, int64_t a, int64_t n) {
    return base + (a * N + n) * K;
  };
  for (int64_t n = 0; n < N; ++n) {
    const double* ip = at(ints, 0, n);
    const double* up = at(unis, 0, n);
    for (int64_t k = 0; k < K; ++k) {
      run_int[k] += ip[k];
      run_uni[k] += up[k];
    }
  }
  auto miou = [&](const std::vector<double>& ri,
                  const std::vector<double>& ru) {
    double s = 0.0;
    int64_t c = 0;
    for (int64_t k = 0; k < K; ++k) {
      if (ru[k] > 0.0) {
        s += ri[k] / ru[k];
        ++c;
      }
    }
    return c ? s / static_cast<double>(c) : 0.0;
  };

  double final_miou = miou(run_int, run_uni);
  double prev_best = 10.0;
  std::mt19937_64 rng(seed);
  std::vector<double> cand_i(K), cand_u(K);

  for (int64_t round = 0; round < n_rounds; ++round) {
    // Fisher-Yates shuffle
    for (int64_t i = N - 1; i > 0; --i) {
      std::uniform_int_distribution<int64_t> dist(0, i);
      std::swap(order[i], order[dist(rng)]);
    }
    for (int64_t oi = 0; oi < N; ++oi) {
      int64_t idx = order[oi];
      for (int64_t a = 0; a < A; ++a) {
        const double* ai = at(ints, a, idx);
        const double* au = at(unis, a, idx);
        const double* si = at(ints, selected[idx], idx);
        const double* su = at(unis, selected[idx], idx);
        // candidate running sums + epsilon-scored mIoU over classes with
        // CURRENT union > 0 (parity: worse_only.py:79-93)
        double s = 0.0;
        int64_t c = 0;
        for (int64_t k = 0; k < K; ++k) {
          cand_i[k] = run_int[k] + ai[k] - si[k];
          cand_u[k] = run_uni[k] + au[k] - su[k];
          if (run_uni[k] > 0.0) {
            s += cand_i[k] / (cand_u[k] + 1e-8);
            ++c;
          }
        }
        double est = c ? s / static_cast<double>(c) : 0.0;
        if (est < final_miou) {
          selected[idx] = a;
          run_int = cand_i;
          run_uni = cand_u;
        }
      }
      // threshold refresh after each image (parity: worse_only.py:323-326)
      final_miou = miou(run_int, run_uni);
    }
    if (prev_best - final_miou <= tol) break;
    prev_best = final_miou;
  }
  return final_miou;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Reference-bug-compatible engine (tools/worse_only.py:79-93,279-334).
//
// The published code's `_compute_miou_subtraction` zips the running
// intersection/union lists against the K-length per-image update vectors
// (truncating to the shorter), drops entries whose CURRENT union is zero,
// and returns the SHRUNK lists; an accepted swap installs them as the new
// running state — from then on class indices silently misalign. This
// replicates that arithmetic exactly, and drives the shuffle with a
// CPython-compatible MT19937 (init_by_array seeding + getrandbits-based
// _randbelow), so trajectories are bit-identical to
// `_worst_case_miou_reference_py` for the same integer seed.
// ---------------------------------------------------------------------------

namespace {

struct PyMT19937 {
  // Standard MT19937 with CPython's integer seeding (init_by_array over
  // the 32-bit little-endian words of |seed|).
  uint32_t mt[624];
  int mti;

  void init_genrand(uint32_t s) {
    mt[0] = s;
    for (mti = 1; mti < 624; mti++)
      mt[mti] = 1812433253u * (mt[mti - 1] ^ (mt[mti - 1] >> 30)) +
                static_cast<uint32_t>(mti);
  }

  explicit PyMT19937(uint64_t seed) {
    uint32_t key[2] = {static_cast<uint32_t>(seed & 0xffffffffu),
                       static_cast<uint32_t>(seed >> 32)};
    int key_len = (seed >> 32) ? 2 : 1;
    init_genrand(19650218u);
    int i = 1, j = 0;
    int k = 624 > key_len ? 624 : key_len;
    for (; k; k--) {
      mt[i] = (mt[i] ^ ((mt[i - 1] ^ (mt[i - 1] >> 30)) * 1664525u)) +
              key[j] + static_cast<uint32_t>(j);
      i++; j++;
      if (i >= 624) { mt[0] = mt[623]; i = 1; }
      if (j >= key_len) j = 0;
    }
    for (k = 623; k; k--) {
      mt[i] = (mt[i] ^ ((mt[i - 1] ^ (mt[i - 1] >> 30)) * 1566083941u)) -
              static_cast<uint32_t>(i);
      i++;
      if (i >= 624) { mt[0] = mt[623]; i = 1; }
    }
    mt[0] = 0x80000000u;
    mti = 624;
  }

  uint32_t next32() {
    if (mti >= 624) {
      for (int k = 0; k < 624; k++) {
        uint32_t y = (mt[k] & 0x80000000u) | (mt[(k + 1) % 624] & 0x7fffffffu);
        mt[k] = mt[(k + 397) % 624] ^ (y >> 1) ^ ((y & 1u) ? 0x9908b0dfu : 0u);
      }
      mti = 0;
    }
    uint32_t y = mt[mti++];
    y ^= y >> 11;
    y ^= (y << 7) & 0x9d2c5680u;
    y ^= (y << 15) & 0xefc60000u;
    y ^= y >> 18;
    return y;
  }

  // CPython Random._randbelow: getrandbits(bit_length(n)) with rejection.
  uint64_t randbelow(uint64_t n) {
    int k = 0;
    for (uint64_t t = n; t; t >>= 1) ++k;
    for (;;) {
      uint64_t r;
      if (k <= 32) {
        r = next32() >> (32 - k);
      } else {  // getrandbits > 32: low word first, 32 bits at a time
        uint64_t lo = next32();
        uint64_t hi = next32() >> (64 - k);
        r = lo | (hi << 32);
      }
      if (r < n) return r;
    }
  }

  // random.shuffle: reversed(range(1, len)) swaps with _randbelow(i+1)
  void shuffle(std::vector<int64_t>& v) {
    for (int64_t i = static_cast<int64_t>(v.size()) - 1; i > 0; --i) {
      int64_t j = static_cast<int64_t>(randbelow(static_cast<uint64_t>(i + 1)));
      std::swap(v[i], v[j]);
    }
  }
};

}  // namespace

extern "C" {

double worst_case_miou_reference(const double* ints, const double* unis,
                                 int64_t A, int64_t N, int64_t K,
                                 int64_t n_rounds, double tol, uint64_t seed,
                                 int64_t* selected) {
  std::vector<double> run_int(K), run_uni(K);
  std::vector<int64_t> order(N);
  auto at = [&](const double* base, int64_t a, int64_t n) {
    return base + (a * N + n) * K;
  };
  for (int64_t k = 0; k < K; ++k) { run_int[k] = 0.0; run_uni[k] = 0.0; }
  for (int64_t n = 0; n < N; ++n) {
    selected[n] = 0;
    order[n] = n;
    const double* ip = at(ints, 0, n);
    const double* up = at(unis, 0, n);
    for (int64_t k = 0; k < K; ++k) {
      run_int[k] += ip[k];
      run_uni[k] += up[k];
    }
  }
  auto miou = [](const std::vector<double>& ri,
                 const std::vector<double>& ru) {
    double s = 0.0;
    int64_t c = 0;
    for (size_t k = 0; k < ri.size(); ++k) {
      if (ru[k] != 0.0) {  // reference: `if b == 0: continue`
        s += ri[k] / ru[k];
        ++c;
      }
    }
    return c ? s / static_cast<double>(c) : 0.0;
  };

  double final_miou = miou(run_int, run_uni);
  double prev_best = 10.0;
  PyMT19937 rng(seed);
  std::vector<double> new_i, new_u;
  new_i.reserve(K);
  new_u.reserve(K);

  for (int64_t round = 0; round < n_rounds; ++round) {
    for (int64_t i = 0; i < N; ++i) order[i] = i;
    rng.shuffle(order);
    for (int64_t oi = 0; oi < N; ++oi) {
      int64_t idx = order[oi];
      for (int64_t a = 0; a < A; ++a) {
        const double* ai = at(ints, a, idx);
        const double* au = at(unis, a, idx);
        const double* si = at(ints, selected[idx], idx);
        const double* su = at(unis, selected[idx], idx);
        // zip truncates to the (possibly shrunk) running length
        int64_t lim = static_cast<int64_t>(run_int.size());
        if (K < lim) lim = K;
        new_i.clear();
        new_u.clear();
        double s = 0.0;
        int64_t c = 0;
        for (int64_t k = 0; k < lim; ++k) {
          if (run_uni[k] == 0.0) continue;  // shrink: dropped entries
          double ni = run_int[k] + ai[k] - si[k];
          double nu = run_uni[k] + au[k] - su[k];
          new_i.push_back(ni);
          new_u.push_back(nu);
          s += ni / (nu + 1e-8);
          ++c;
        }
        double est = c ? s / static_cast<double>(c) : 0.0;
        if (est < final_miou) {
          selected[idx] = a;
          run_int = new_i;
          run_uni = new_u;
        }
      }
      final_miou = miou(run_int, run_uni);
    }
    if (prev_best - final_miou <= tol) break;
    prev_best = final_miou;
  }
  return final_miou;
}

}  // extern "C"

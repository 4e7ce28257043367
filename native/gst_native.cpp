// Native runtime components for gemini_seal.
//
// The reference implements its host runtime (PRNG, samplers, serialization
// helpers) in C/C++ (randomgen.cpp, util/blake2b.c, util/rlwe.cpp); this is
// this framework's native equivalent, exposed through a flat C ABI consumed
// via ctypes (gemini_seal/utils/native.py).  The BLAKE2b implementation
// is written from the RFC 7693 specification.
//
// Build: tools/build_native.sh -> gemini_seal/_gst_native.so

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>

namespace {

constexpr uint64_t IV[8] = {
    0x6a09e667f3bcc908ULL, 0xbb67ae8584caa73bULL, 0x3c6ef372fe94f82bULL,
    0xa54ff53a5f1d36f1ULL, 0x510e527fade682d1ULL, 0x9b05688c2b3e6c1fULL,
    0x1f83d9abfb41bd6bULL, 0x5be0cd19137e2179ULL,
};

constexpr uint8_t SIGMA[12][16] = {
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3},
    {11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4},
    {7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8},
    {9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13},
    {2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9},
    {12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11},
    {13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10},
    {6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5},
    {10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3},
};

inline uint64_t rotr64(uint64_t x, int c) { return (x >> c) | (x << (64 - c)); }

inline void g(uint64_t *v, int a, int b, int c, int d, uint64_t x, uint64_t y) {
  v[a] += v[b] + x;
  v[d] = rotr64(v[d] ^ v[a], 32);
  v[c] += v[d];
  v[b] = rotr64(v[b] ^ v[c], 24);
  v[a] += v[b] + y;
  v[d] = rotr64(v[d] ^ v[a], 16);
  v[c] += v[d];
  v[b] = rotr64(v[b] ^ v[c], 63);
}

void compress(uint64_t h[8], const uint8_t block[128], uint64_t t, bool last) {
  uint64_t m[16], v[16];
  std::memcpy(m, block, 128);
  for (int i = 0; i < 8; i++) v[i] = h[i];
  for (int i = 0; i < 8; i++) v[8 + i] = IV[i];
  v[12] ^= t;
  // t is at most the stream length here; the high word stays 0.
  if (last) v[14] = ~v[14];
  for (int r = 0; r < 12; r++) {
    const uint8_t *s = SIGMA[r];
    g(v, 0, 4, 8, 12, m[s[0]], m[s[1]]);
    g(v, 1, 5, 9, 13, m[s[2]], m[s[3]]);
    g(v, 2, 6, 10, 14, m[s[4]], m[s[5]]);
    g(v, 3, 7, 11, 15, m[s[6]], m[s[7]]);
    g(v, 0, 5, 10, 15, m[s[8]], m[s[9]]);
    g(v, 1, 6, 11, 12, m[s[10]], m[s[11]]);
    g(v, 2, 7, 8, 13, m[s[12]], m[s[13]]);
    g(v, 3, 4, 9, 14, m[s[14]], m[s[15]]);
  }
  for (int i = 0; i < 8; i++) h[i] ^= v[i] ^ v[8 + i];
}

// Parameter-block word 0: digest_length | key_length<<8 | fanout<<16 |
// depth<<24 | leaf_length<<32.
inline uint64_t param_w0(uint8_t dl, uint8_t kl, uint8_t fo, uint8_t dp,
                         uint32_t leaf) {
  return (uint64_t)dl | ((uint64_t)kl << 8) | ((uint64_t)fo << 16) |
         ((uint64_t)dp << 24) | ((uint64_t)leaf << 32);
}

}  // namespace

extern "C" {

// blake2xb(out, outlen, in, inlen, key, keylen) — bit-compatible with the
// reference's util/blake2xb.c XOF construction.
int gst_blake2xb(uint8_t *out, uint64_t outlen, const uint8_t *in,
                 uint64_t inlen, const uint8_t *key, uint64_t keylen) {
  if (!out || outlen == 0 || outlen > 0xFFFFFFFFULL || keylen > 64) return -1;

  // Root hash: keyed sequential blake2b-512 with xof_length planted in the
  // parameter block (node_offset high word).
  uint64_t h[8];
  for (int i = 0; i < 8; i++) h[i] = IV[i];
  h[0] ^= param_w0(64, (uint8_t)keylen, 1, 1, 0);
  h[1] ^= (uint64_t)outlen << 32;  // node_offset=0 | xof_length<<32

  uint8_t block[128];
  uint64_t t = 0;
  if (keylen > 0) {
    std::memset(block, 0, 128);
    std::memcpy(block, key, keylen);
    if (inlen == 0) {
      compress(h, block, 128, true);
      t = 128;
    } else {
      compress(h, block, 128, false);
      t = 128;
    }
  }
  // message blocks
  uint64_t pos = 0;
  if (inlen > 0 || keylen == 0) {
    while (inlen - pos > 128) {
      t += 128;
      compress(h, in + pos, t, false);
      pos += 128;
    }
    std::memset(block, 0, 128);
    std::memcpy(block, in + pos, inlen - pos);
    t += inlen - pos;
    compress(h, block, t, true);
  }
  uint8_t root[128];
  std::memset(root, 0, 128);
  std::memcpy(root, h, 64);

  // Output blocks: fanout=0, depth=0, leaf=64, inner=64,
  // node_offset = i | xof_length<<32.
  uint64_t produced = 0;
  uint32_t i = 0;
  while (produced < outlen) {
    uint64_t want = outlen - produced;
    uint8_t dl = want < 64 ? (uint8_t)want : 64;
    uint64_t ho[8];
    for (int k = 0; k < 8; k++) ho[k] = IV[k];
    ho[0] ^= param_w0(dl, 0, 0, 0, 64);
    ho[1] ^= (uint64_t)i | ((uint64_t)outlen << 32);
    ho[2] ^= (uint64_t)64 << 8;  // inner_length
    compress(ho, root, 64, true);
    std::memcpy(out + produced, ho, dl);
    produced += dl;
    i++;
  }
  return 0;
}

// Fill `out` with the BlakePRNG stream: consecutive
// blake2xb(4096, LE64(counter), seed[64 bytes]) blocks starting at
// counter_start (randomgen.cpp:63-74).  nbytes must be a multiple of 4096.
int gst_prng_fill(uint8_t *out, uint64_t nbytes, const uint64_t seed[8],
                  uint64_t counter_start) {
  if (nbytes % 4096 != 0) return -1;
  uint64_t counter = counter_start;
  for (uint64_t off = 0; off < nbytes; off += 4096, counter++) {
    uint8_t ctr_le[8];
    std::memcpy(ctr_le, &counter, 8);
    if (gst_blake2xb(out + off, 4096, ctr_le, 8,
                     reinterpret_cast<const uint8_t *>(seed), 64) != 0)
      return -1;
  }
  return 0;
}


// ---------------------------------------------------------------------------
// Serialization framing (the native IO path of the runtime).
// SEALHeader {magic 0xA15E, size 0x10, version 3.5, compr_mode, reserved,
// u64 total} + optional zlib deflate — byte-identical to the reference's
// Serialization::Save (serialization.{h,cpp}) and to the Python fallback
// (gemini_seal/serialization.py uses the same zlib at default level).
// ---------------------------------------------------------------------------

#include <zlib.h>

// Frame `payload` into `out` (caller allocates >= gst_frame_bound(n) bytes).
// Returns the framed size, or -1 on error.  compr: 0=none, 1=deflate.
int64_t gst_frame_bound(uint64_t payload_len) {
  return 16 + (int64_t)compressBound((uLong)payload_len);
}

int64_t gst_frame(uint8_t *out, const uint8_t *payload, uint64_t payload_len,
                  int compr) {
  uint64_t body_len = payload_len;
  if (compr == 1) {
    uLongf dest_len = compressBound((uLong)payload_len);
    if (compress2(out + 16, &dest_len, payload, (uLong)payload_len,
                  Z_DEFAULT_COMPRESSION) != Z_OK)
      return -1;
    body_len = dest_len;
  } else if (compr == 0) {
    std::memcpy(out + 16, payload, payload_len);
  } else {
    return -1;
  }
  uint64_t total = 16 + body_len;
  out[0] = 0x5E; out[1] = 0xA1;            // magic 0xA15E little-endian
  out[2] = 0x10;                           // header size
  out[3] = 3; out[4] = 5;                  // version 3.5
  out[5] = (uint8_t)compr;
  out[6] = 0; out[7] = 0;                  // reserved u16
  std::memcpy(out + 8, &total, 8);
  return (int64_t)total;
}

// Unframe: validates the header, inflates if needed.  Returns the payload
// size written to `out` (caller allocates >= out_cap), or -1 on a bad
// header / -2 if out_cap is too small / -3 on inflate error.
int64_t gst_unframe(uint8_t *out, uint64_t out_cap, const uint8_t *data,
                    uint64_t data_len) {
  if (data_len < 16) return -1;
  if (data[0] != 0x5E || data[1] != 0xA1 || data[2] != 0x10) return -1;
  uint8_t compr = data[5];
  uint64_t total;
  std::memcpy(&total, data + 8, 8);
  if (total < 16) return -1;               // header must cover itself
  if (total > data_len) total = data_len;  // stream semantics (see .py)
  if (total < 16) return -1;
  if (compr == 0) {
    uint64_t n = data_len - 16;            // hand back the whole remainder
    if (n > out_cap) return -2;
    std::memcpy(out, data + 16, n);
    return (int64_t)n;
  }
  if (compr == 1) {
    uLongf dest_len = (uLongf)out_cap;
    int rc = uncompress(out, &dest_len, data + 16, (uLong)(total - 16));
    if (rc == Z_BUF_ERROR) return -2;
    if (rc != Z_OK) return -3;
    return (int64_t)dest_len;
  }
  return -1;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Host-plane negacyclic NTT (forward/inverse), bit-identical to the
// vectorized transforms in gemini_seal/ops/ntt.py (which are pinned to
// the reference ntt.cpp:213-282): Shoup lazy butterflies, forward output
// [0, 4p) (canonical via two conditional subtracts), inverse [0, 2p)
// (canonical via one).  The host object layer (encoders, decryptor,
// encryptor) calls these instead of paying numpy's per-stage passes.
// ---------------------------------------------------------------------------

static inline uint64_t mulhi_u64(uint64_t a, uint64_t b) {
  return (uint64_t)(((unsigned __int128)a * b) >> 64);
}

static void ntt_fwd_row(uint64_t *x, uint64_t n, uint64_t log_n,
                        const uint64_t *w_row, const uint64_t *ws_row,
                        uint64_t p, int canonical) {
  const uint64_t two_p = p << 1;
  for (uint64_t s = 0; s < log_n; s++) {
    uint64_t m = (uint64_t)1 << s;
    uint64_t h = n >> (s + 1);
    for (uint64_t i = 0; i < m; i++) {
      uint64_t w = w_row[m + i];
      uint64_t ws = ws_row[m + i];
      uint64_t *x0 = x + 2 * i * h;
      uint64_t *x1 = x0 + h;
      for (uint64_t k = 0; k < h; k++) {
        uint64_t a = x0[k];
        if (a >= two_p) a -= two_p;
        uint64_t b = x1[k];
        uint64_t q = mulhi_u64(b, ws);
        uint64_t v = b * w - q * p;          // [0, 2p)
        x0[k] = a + v;
        x1[k] = a - v + two_p;
      }
    }
  }
  if (canonical) {
    for (uint64_t k = 0; k < n; k++) {
      uint64_t a = x[k];
      if (a >= two_p) a -= two_p;
      if (a >= p) a -= p;
      x[k] = a;
    }
  }
}

static void ntt_inv_row(uint64_t *x, uint64_t n, uint64_t log_n,
                        const uint64_t *w_row, const uint64_t *ws_row,
                        uint64_t inv_n, uint64_t inv_n_s, uint64_t p,
                        int canonical) {
  const uint64_t two_p = p << 1;
  uint64_t ofs = 1;
  for (uint64_t s = 0; s < log_n; s++) {
    uint64_t m = n >> (s + 1);
    uint64_t h = (uint64_t)1 << s;
    for (uint64_t i = 0; i < m; i++) {
      uint64_t w = w_row[ofs + i];
      uint64_t ws = ws_row[ofs + i];
      uint64_t *x0 = x + 2 * i * h;
      uint64_t *x1 = x0 + h;
      for (uint64_t k = 0; k < h; k++) {
        uint64_t a = x0[k];
        uint64_t b = x1[k];
        uint64_t t = a + b;
        if (t >= two_p) t -= two_p;
        uint64_t d = a - b + two_p;
        if (m == 1) {
          uint64_t q = mulhi_u64(t, inv_n_s);
          t = t * inv_n - q * p;
        }
        uint64_t qd = mulhi_u64(d, ws);
        x0[k] = t;
        x1[k] = d * w - qd * p;
      }
    }
    ofs += m;
  }
  if (canonical) {
    for (uint64_t k = 0; k < n; k++) {
      uint64_t a = x[k];
      if (a >= p) a -= p;
      x[k] = a;
    }
  }
}

extern "C" {

// x: [rows, L, n] row-major, transformed IN PLACE per (row, limb).
// w/ws: [L, n]; mods (+inv_n/inv_n_s for the inverse): [L].
void gst_ntt_forward(uint64_t *x, uint64_t rows, uint64_t L, uint64_t log_n,
                     const uint64_t *w, const uint64_t *ws,
                     const uint64_t *mods, int canonical) {
  uint64_t n = (uint64_t)1 << log_n;
  for (uint64_t r = 0; r < rows; r++)
    for (uint64_t l = 0; l < L; l++)
      ntt_fwd_row(x + (r * L + l) * n, n, log_n, w + l * n, ws + l * n,
                  mods[l], canonical);
}

void gst_ntt_inverse(uint64_t *x, uint64_t rows, uint64_t L, uint64_t log_n,
                     const uint64_t *w, const uint64_t *ws,
                     const uint64_t *inv_n, const uint64_t *inv_n_s,
                     const uint64_t *mods, int canonical) {
  uint64_t n = (uint64_t)1 << log_n;
  for (uint64_t r = 0; r < rows; r++)
    for (uint64_t l = 0; l < L; l++)
      ntt_inv_row(x + (r * L + l) * n, n, log_n, w + l * n, ws + l * n,
                  inv_n[l], inv_n_s[l], mods[l], canonical);
}

// CRT compose: residues [L, n] -> base-2^64 limb planes out [K, n] holding
// the unique v in [0, q).  inv_punc[L], mods[L], qhat [L, K] words
// (little-endian), qprod [K+1] words of q.  Exact-integer semantics equal
// to utils/mplimb.compose_limbs (reference: rns.cpp:369-414).
void gst_crt_compose(uint64_t *out, const uint64_t *residues, uint64_t n,
                     uint64_t L, uint64_t K, const uint64_t *inv_punc,
                     const uint64_t *mods, const uint64_t *qhat,
                     const uint64_t *qprod) {
  std::vector<uint64_t> acc(K + 1);
  for (uint64_t i = 0; i < n; i++) {
    for (uint64_t k = 0; k <= K; k++) acc[k] = 0;
    for (uint64_t j = 0; j < L; j++) {
      uint64_t p = mods[j];
      uint64_t t =
          (uint64_t)(((unsigned __int128)residues[j * n + i] * inv_punc[j]) % p);
      unsigned __int128 carry = 0;
      for (uint64_t k = 0; k < K; k++) {
        unsigned __int128 cur =
            (unsigned __int128)t * qhat[j * K + k] + acc[k] + (uint64_t)carry;
        acc[k] = (uint64_t)cur;
        carry = cur >> 64;
      }
      acc[K] += (uint64_t)carry;
    }
    // at most L-1 conditional big-subtractions of q
    for (uint64_t it = 0; it + 1 < L || it == 0; it++) {
      // compare acc (K+1 words) >= qprod (K+1 words, top word 0 or q's)
      int ge = 1;
      for (int64_t k = (int64_t)K; k >= 0; k--) {
        uint64_t qa = qprod[k];
        if (acc[k] > qa) { ge = 1; break; }
        if (acc[k] < qa) { ge = 0; break; }
      }
      if (!ge) break;
      unsigned __int128 borrow = 0;
      for (uint64_t k = 0; k <= K; k++) {
        unsigned __int128 sub = (unsigned __int128)qprod[k] + (uint64_t)borrow;
        uint64_t a = acc[k];
        acc[k] = (uint64_t)((unsigned __int128)a - sub);
        borrow = ((unsigned __int128)a < sub) ? 1 : 0;
      }
    }
    for (uint64_t k = 0; k < K; k++) out[k * n + i] = acc[k];
  }
}

// Fused CKKS decode ladder: CRT-compose + centered lift + LSB-first double
// conversion in ONE pass per coefficient (no [K, n] limb-plane
// materialization).  out[i] = +-(sum_k mag[k] * inv_scale * 2^(64k)) with
// mag = v >= upper ? q - v : v; identical compose to gst_crt_compose and
// identical IEEE accumulation order to utils/mplimb.ladder_to_double, so
// results are bit-exact with the Python path (reference: ckks.h:668-744).
// upper: [K] words of (q+1)/2; qprod: [K+1] words of q.
void gst_crt_centered_double(double *out, const uint64_t *residues,
                             uint64_t n, uint64_t L, uint64_t K,
                             const uint64_t *inv_punc, const uint64_t *mods,
                             const uint64_t *qhat, const uint64_t *qprod,
                             const uint64_t *upper, double inv_scale) {
  std::vector<uint64_t> acc(K + 1);
  std::vector<double> pow64(K);
  double s = inv_scale;
  for (uint64_t k = 0; k < K; k++) {
    pow64[k] = s;
    s *= 18446744073709551616.0;  // 2^64
  }
  for (uint64_t i = 0; i < n; i++) {
    for (uint64_t k = 0; k <= K; k++) acc[k] = 0;
    for (uint64_t j = 0; j < L; j++) {
      uint64_t p = mods[j];
      uint64_t t =
          (uint64_t)(((unsigned __int128)residues[j * n + i] * inv_punc[j]) % p);
      unsigned __int128 carry = 0;
      for (uint64_t k = 0; k < K; k++) {
        unsigned __int128 cur =
            (unsigned __int128)t * qhat[j * K + k] + acc[k] + (uint64_t)carry;
        acc[k] = (uint64_t)cur;
        carry = cur >> 64;
      }
      acc[K] += (uint64_t)carry;
    }
    for (uint64_t it = 0; it + 1 < L || it == 0; it++) {
      int ge = 1;
      for (int64_t k = (int64_t)K; k >= 0; k--) {
        uint64_t qa = qprod[k];
        if (acc[k] > qa) { ge = 1; break; }
        if (acc[k] < qa) { ge = 0; break; }
      }
      if (!ge) break;
      unsigned __int128 borrow = 0;
      for (uint64_t k = 0; k <= K; k++) {
        unsigned __int128 sub = (unsigned __int128)qprod[k] + (uint64_t)borrow;
        uint64_t a = acc[k];
        acc[k] = (uint64_t)((unsigned __int128)a - sub);
        borrow = ((unsigned __int128)a < sub) ? 1 : 0;
      }
    }
    // centered lift: v >= (q+1)/2 decodes as -(q - v)
    int neg = 1;  // acc >= upper, ties (equal) included
    for (int64_t k = (int64_t)K - 1; k >= 0; k--) {
      if (acc[k] > upper[k]) { neg = 1; break; }
      if (acc[k] < upper[k]) { neg = 0; break; }
    }
    if (neg) {
      unsigned __int128 borrow = 0;
      for (uint64_t k = 0; k < K; k++) {
        unsigned __int128 sub = (unsigned __int128)acc[k] + (uint64_t)borrow;
        uint64_t qa = qprod[k];
        acc[k] = (uint64_t)((unsigned __int128)qa - sub);
        borrow = ((unsigned __int128)qa < sub) ? 1 : 0;
      }
    }
    double v = 0.0;
    for (uint64_t k = 0; k < K; k++) v = v + (double)acc[k] * pow64[k];
    out[i] = neg ? -v : v;
  }
}

// Exact RNS decomposition of rounded (integer-valued) doubles: dest [L, n].
// Small |v| < 2^62 go through int64; larger through the exact mantissa/
// exponent split against pow2 [L, smax] (2^s mod p).  Matches
// CKKSEncoder._decompose_exact (reference regimes: ckks.h:514-607).
void gst_decompose_rounded(uint64_t *dest, const double *rounded, uint64_t n,
                           uint64_t L, const uint64_t *mods,
                           const uint64_t *pow2, uint64_t smax) {
  for (uint64_t i = 0; i < n; i++) {
    double v = rounded[i];
    double av = v < 0 ? -v : v;
    if (av < 4611686018427387904.0 /* 2^62 */) {
      int64_t iv = (int64_t)v;
      for (uint64_t j = 0; j < L; j++) {
        int64_t p = (int64_t)mods[j];
        int64_t r = iv % p;
        if (r < 0) r += p;
        dest[j * n + i] = (uint64_t)r;
      }
    } else {
      int e;
      double m = std::frexp(v, &e);
      int64_t m_int = (int64_t)(m * 9007199254740992.0); /* *2^53, exact */
      uint64_t shift = (uint64_t)(e - 53);
      for (uint64_t j = 0; j < L; j++) {
        int64_t p = (int64_t)mods[j];
        int64_t rm = m_int % p;
        if (rm < 0) rm += p;
        uint64_t r = (uint64_t)(((unsigned __int128)(uint64_t)rm *
                                 pow2[j * smax + shift]) %
                                (uint64_t)p);
        dest[j * n + i] = r;
      }
    }
  }
}

}  // extern "C"

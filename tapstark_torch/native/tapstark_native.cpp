// tapstark native commit engine.
//
// The TPU-native equivalent of the runtime-native work the reference does in
// Rust (taptree assembly + hashing, Winternitz chains; reference
// basic/src/tcs/, scripts/src/bit_comm/). Exposed as a C ABI for ctypes:
//   - winternitz_pubkeys_batch: hash160 chains for bit-commitment keys
//   - tcs_commit: bulk leaf-script assembly, tapleaf hashing, ordered
//     taptree build emitting level hashes (branches derived by indexing)
//
// Self-contained SHA-256 / RIPEMD-160 (no external deps).

#include <cstdint>
#include <cstring>
#include <vector>

#if defined(__SHA__) && defined(__SSE4_1__)
#define TAPSTARK_SHA_NI 1
#endif
#if defined(__AVX2__)
#define TAPSTARK_AVX2 1
#endif
#if defined(TAPSTARK_SHA_NI) || defined(TAPSTARK_AVX2)
#include <immintrin.h>
#endif

// ---------------------------------------------------------------------------
// SHA-256
// ---------------------------------------------------------------------------

namespace sha256impl {

static const uint32_t K[64] = {
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};

static inline uint32_t rotr(uint32_t x, int n) {
  return (x >> n) | (x << (32 - n));
}

#ifdef TAPSTARK_SHA_NI
// SHA-NI one-block compression (ABEF/CDGH register packing, canonical
// round/message-schedule interleaving).
static void block_ni(uint32_t h[8], const uint8_t* p) {
  const __m128i MASK =
      _mm_set_epi64x(0x0c0d0e0f08090a0bULL, 0x0405060700010203ULL);
  __m128i tmp = _mm_loadu_si128((const __m128i*)&h[0]);
  __m128i st1 = _mm_loadu_si128((const __m128i*)&h[4]);
  tmp = _mm_shuffle_epi32(tmp, 0xB1);       // CDAB
  st1 = _mm_shuffle_epi32(st1, 0x1B);       // EFGH
  __m128i st0 = _mm_alignr_epi8(tmp, st1, 8);  // ABEF
  st1 = _mm_blend_epi16(st1, tmp, 0xF0);    // CDGH
  const __m128i abef_save = st0, cdgh_save = st1;

  __m128i m[4];
  m[0] = _mm_shuffle_epi8(_mm_loadu_si128((const __m128i*)(p + 0)), MASK);
  m[1] = _mm_shuffle_epi8(_mm_loadu_si128((const __m128i*)(p + 16)), MASK);
  m[2] = _mm_shuffle_epi8(_mm_loadu_si128((const __m128i*)(p + 32)), MASK);
  m[3] = _mm_shuffle_epi8(_mm_loadu_si128((const __m128i*)(p + 48)), MASK);

  for (int g = 0; g < 16; g++) {
    __m128i wk =
        _mm_add_epi32(m[g & 3], _mm_loadu_si128((const __m128i*)&K[4 * g]));
    st1 = _mm_sha256rnds2_epu32(st1, st0, wk);
    wk = _mm_shuffle_epi32(wk, 0x0E);
    st0 = _mm_sha256rnds2_epu32(st0, st1, wk);
    if (g >= 1 && g <= 2) {
      m[g - 1] = _mm_sha256msg1_epu32(m[g - 1], m[g]);
    } else if (g >= 3 && g <= 14) {
      int cur = g & 3, prv = (g + 3) & 3, nxt = (g + 1) & 3;
      __m128i t = _mm_alignr_epi8(m[cur], m[prv], 4);
      m[nxt] = _mm_sha256msg2_epu32(_mm_add_epi32(m[nxt], t), m[cur]);
      m[prv] = _mm_sha256msg1_epu32(m[prv], m[cur]);
    }
  }

  st0 = _mm_add_epi32(st0, abef_save);
  st1 = _mm_add_epi32(st1, cdgh_save);

  tmp = _mm_shuffle_epi32(st0, 0x1B);       // FEBA
  st1 = _mm_shuffle_epi32(st1, 0xB1);       // DCHG
  st0 = _mm_blend_epi16(tmp, st1, 0xF0);    // DCBA
  st1 = _mm_alignr_epi8(st1, tmp, 8);       // HGFE
  _mm_storeu_si128((__m128i*)&h[0], st0);
  _mm_storeu_si128((__m128i*)&h[4], st1);
}

// Two interleaved one-block compressions. sha256rnds2 is latency-bound on a
// single stream (each round depends on the previous); running two
// independent streams in lockstep nearly doubles block throughput.
static void block_ni2(uint32_t ha[8], uint32_t hb[8], const uint8_t* pa,
                      const uint8_t* pb) {
  const __m128i MASK =
      _mm_set_epi64x(0x0c0d0e0f08090a0bULL, 0x0405060700010203ULL);
  __m128i ta = _mm_loadu_si128((const __m128i*)&ha[0]);
  __m128i a1 = _mm_loadu_si128((const __m128i*)&ha[4]);
  ta = _mm_shuffle_epi32(ta, 0xB1);
  a1 = _mm_shuffle_epi32(a1, 0x1B);
  __m128i a0 = _mm_alignr_epi8(ta, a1, 8);
  a1 = _mm_blend_epi16(a1, ta, 0xF0);
  const __m128i a0s = a0, a1s = a1;

  __m128i tb = _mm_loadu_si128((const __m128i*)&hb[0]);
  __m128i b1 = _mm_loadu_si128((const __m128i*)&hb[4]);
  tb = _mm_shuffle_epi32(tb, 0xB1);
  b1 = _mm_shuffle_epi32(b1, 0x1B);
  __m128i b0 = _mm_alignr_epi8(tb, b1, 8);
  b1 = _mm_blend_epi16(b1, tb, 0xF0);
  const __m128i b0s = b0, b1s = b1;

  __m128i ma[4], mb[4];
  for (int j = 0; j < 4; j++) {
    ma[j] = _mm_shuffle_epi8(_mm_loadu_si128((const __m128i*)(pa + 16 * j)),
                             MASK);
    mb[j] = _mm_shuffle_epi8(_mm_loadu_si128((const __m128i*)(pb + 16 * j)),
                             MASK);
  }

  for (int g = 0; g < 16; g++) {
    const __m128i kk = _mm_loadu_si128((const __m128i*)&K[4 * g]);
    __m128i wka = _mm_add_epi32(ma[g & 3], kk);
    __m128i wkb = _mm_add_epi32(mb[g & 3], kk);
    a1 = _mm_sha256rnds2_epu32(a1, a0, wka);
    b1 = _mm_sha256rnds2_epu32(b1, b0, wkb);
    wka = _mm_shuffle_epi32(wka, 0x0E);
    wkb = _mm_shuffle_epi32(wkb, 0x0E);
    a0 = _mm_sha256rnds2_epu32(a0, a1, wka);
    b0 = _mm_sha256rnds2_epu32(b0, b1, wkb);
    if (g >= 1 && g <= 2) {
      ma[g - 1] = _mm_sha256msg1_epu32(ma[g - 1], ma[g]);
      mb[g - 1] = _mm_sha256msg1_epu32(mb[g - 1], mb[g]);
    } else if (g >= 3 && g <= 14) {
      int cur = g & 3, prv = (g + 3) & 3, nxt = (g + 1) & 3;
      __m128i t = _mm_alignr_epi8(ma[cur], ma[prv], 4);
      ma[nxt] = _mm_sha256msg2_epu32(_mm_add_epi32(ma[nxt], t), ma[cur]);
      ma[prv] = _mm_sha256msg1_epu32(ma[prv], ma[cur]);
      t = _mm_alignr_epi8(mb[cur], mb[prv], 4);
      mb[nxt] = _mm_sha256msg2_epu32(_mm_add_epi32(mb[nxt], t), mb[cur]);
      mb[prv] = _mm_sha256msg1_epu32(mb[prv], mb[cur]);
    }
  }

  a0 = _mm_add_epi32(a0, a0s);
  a1 = _mm_add_epi32(a1, a1s);
  b0 = _mm_add_epi32(b0, b0s);
  b1 = _mm_add_epi32(b1, b1s);

  ta = _mm_shuffle_epi32(a0, 0x1B);
  a1 = _mm_shuffle_epi32(a1, 0xB1);
  a0 = _mm_blend_epi16(ta, a1, 0xF0);
  a1 = _mm_alignr_epi8(a1, ta, 8);
  _mm_storeu_si128((__m128i*)&ha[0], a0);
  _mm_storeu_si128((__m128i*)&ha[4], a1);

  tb = _mm_shuffle_epi32(b0, 0x1B);
  b1 = _mm_shuffle_epi32(b1, 0xB1);
  b0 = _mm_blend_epi16(tb, b1, 0xF0);
  b1 = _mm_alignr_epi8(b1, tb, 8);
  _mm_storeu_si128((__m128i*)&hb[0], b0);
  _mm_storeu_si128((__m128i*)&hb[4], b1);
}
#endif  // TAPSTARK_SHA_NI

static const uint32_t INIT[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372,
                                 0xa54ff53a, 0x510e527f, 0x9b05688c,
                                 0x1f83d9ab, 0x5be0cd19};

static void block_generic(uint32_t h[8], const uint8_t* p);

// one-block compression dispatch (free function: midstate-based paths below
// run compressions without a Ctx)
static inline void sha_block(uint32_t h[8], const uint8_t* p) {
#ifdef TAPSTARK_SHA_NI
  block_ni(h, p);
#else
  block_generic(h, p);
#endif
}

struct Ctx {
  uint32_t h[8];
  uint64_t len = 0;
  uint8_t buf[64];
  size_t buflen = 0;

  Ctx() { memcpy(h, INIT, sizeof(h)); }

  void block(const uint8_t* p) { sha_block(h, p); }

  void update(const uint8_t* p, size_t n) {
    len += n;
    if (buflen) {
      size_t take = 64 - buflen;
      if (take > n) take = n;
      memcpy(buf + buflen, p, take);
      buflen += take;
      p += take;
      n -= take;
      if (buflen == 64) { block(buf); buflen = 0; }
    }
    while (n >= 64) { block(p); p += 64; n -= 64; }
    if (n) { memcpy(buf, p, n); buflen = n; }
  }

  void final(uint8_t out[32]) {
    uint64_t bits = len * 8;
    uint8_t pad = 0x80;
    update(&pad, 1);
    uint8_t z = 0;
    while (buflen != 56) update(&z, 1);
    uint8_t lb[8];
    for (int i = 0; i < 8; i++) lb[i] = uint8_t(bits >> (56 - 8 * i));
    update(lb, 8);
    for (int i = 0; i < 8; i++) {
      out[4 * i] = uint8_t(h[i] >> 24);
      out[4 * i + 1] = uint8_t(h[i] >> 16);
      out[4 * i + 2] = uint8_t(h[i] >> 8);
      out[4 * i + 3] = uint8_t(h[i]);
    }
  }
};

static void block_generic(uint32_t h[8], const uint8_t* p) {
    uint32_t w[64];
    for (int i = 0; i < 16; i++)
      w[i] = (uint32_t(p[4 * i]) << 24) | (uint32_t(p[4 * i + 1]) << 16) |
             (uint32_t(p[4 * i + 2]) << 8) | uint32_t(p[4 * i + 3]);
    for (int i = 16; i < 64; i++) {
      uint32_t s0 = rotr(w[i - 15], 7) ^ rotr(w[i - 15], 18) ^ (w[i - 15] >> 3);
      uint32_t s1 = rotr(w[i - 2], 17) ^ rotr(w[i - 2], 19) ^ (w[i - 2] >> 10);
      w[i] = w[i - 16] + s0 + w[i - 7] + s1;
    }
    uint32_t a = h[0], b = h[1], c = h[2], d = h[3], e = h[4], f = h[5],
             g = h[6], hh = h[7];
    for (int i = 0; i < 64; i++) {
      uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
      uint32_t ch = (e & f) ^ (~e & g);
      uint32_t t1 = hh + S1 + ch + K[i] + w[i];
      uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
      uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
      uint32_t t2 = S0 + maj;
      hh = g; g = f; f = e; e = d + t1;
      d = c; c = b; b = a; a = t1 + t2;
    }
    h[0] += a; h[1] += b; h[2] += c; h[3] += d;
    h[4] += e; h[5] += f; h[6] += g; h[7] += hh;
}

// Two-stream one-block compression (SHA-NI interleave when available).
static inline void sha_block2(uint32_t ha[8], uint32_t hb[8],
                              const uint8_t* pa, const uint8_t* pb) {
#ifdef TAPSTARK_SHA_NI
  block_ni2(ha, hb, pa, pb);
#else
  block_generic(ha, pa);
  block_generic(hb, pb);
#endif
}

// digest (big-endian words) from a state
static inline void sha_digest(const uint32_t h[8], uint8_t out[32]) {
  for (int i = 0; i < 8; i++) {
    out[4 * i] = uint8_t(h[i] >> 24);
    out[4 * i + 1] = uint8_t(h[i] >> 16);
    out[4 * i + 2] = uint8_t(h[i] >> 8);
    out[4 * i + 3] = uint8_t(h[i]);
  }
}

static void hash(const uint8_t* p, size_t n, uint8_t out[32]) {
  Ctx c;
  c.update(p, n);
  c.final(out);
}

}  // namespace sha256impl

// ---------------------------------------------------------------------------
// RIPEMD-160
// ---------------------------------------------------------------------------

namespace rmd160impl {

static inline uint32_t rol(uint32_t x, int n) {
  return (x << n) | (x >> (32 - n));
}

static const int ML[80] = {
    0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
    7, 4, 13, 1, 10, 6, 15, 3, 12, 0, 9, 5, 2, 14, 11, 8,
    3, 10, 14, 4, 9, 15, 8, 1, 2, 7, 0, 6, 13, 11, 5, 12,
    1, 9, 11, 10, 0, 8, 12, 4, 13, 3, 7, 15, 14, 5, 6, 2,
    4, 0, 5, 9, 7, 12, 2, 10, 14, 1, 3, 8, 11, 6, 15, 13};
static const int MR[80] = {
    5, 14, 7, 0, 9, 2, 11, 4, 13, 6, 15, 8, 1, 10, 3, 12,
    6, 11, 3, 7, 0, 13, 5, 10, 14, 15, 8, 12, 4, 9, 1, 2,
    15, 5, 1, 3, 7, 14, 6, 9, 11, 8, 12, 2, 10, 0, 4, 13,
    8, 6, 4, 1, 3, 11, 15, 0, 5, 12, 2, 13, 9, 7, 10, 14,
    12, 15, 10, 4, 1, 5, 8, 7, 6, 2, 13, 14, 0, 3, 9, 11};
static const int RL[80] = {
    11, 14, 15, 12, 5, 8, 7, 9, 11, 13, 14, 15, 6, 7, 9, 8,
    7, 6, 8, 13, 11, 9, 7, 15, 7, 12, 15, 9, 11, 7, 13, 12,
    11, 13, 6, 7, 14, 9, 13, 15, 14, 8, 13, 6, 5, 12, 7, 5,
    11, 12, 14, 15, 14, 15, 9, 8, 9, 14, 5, 6, 8, 6, 5, 12,
    9, 15, 5, 11, 6, 8, 13, 12, 5, 12, 13, 14, 11, 8, 5, 6};
static const int RR[80] = {
    8, 9, 9, 11, 13, 15, 15, 5, 7, 7, 8, 11, 14, 14, 12, 6,
    9, 13, 15, 7, 12, 8, 9, 11, 7, 7, 12, 7, 6, 15, 13, 11,
    9, 7, 15, 11, 8, 6, 6, 14, 12, 13, 5, 14, 13, 13, 7, 5,
    15, 5, 8, 11, 14, 14, 6, 14, 6, 9, 12, 9, 12, 5, 15, 8,
    8, 5, 12, 9, 12, 5, 14, 6, 8, 13, 6, 5, 15, 13, 11, 11};
static const uint32_t KL[5] = {0, 0x5a827999, 0x6ed9eba1, 0x8f1bbcdc,
                               0xa953fd4e};
static const uint32_t KR[5] = {0x50a28be6, 0x5c4dd124, 0x6d703ef3, 0x7a6d76e9,
                               0};

static inline uint32_t fi(uint32_t x, uint32_t y, uint32_t z, int i) {
  switch (i) {
    case 0: return x ^ y ^ z;
    case 1: return (x & y) | (~x & z);
    case 2: return (x | ~y) ^ z;
    case 3: return (x & z) | (y & ~z);
    default: return x ^ (y | ~z);
  }
}

static void compress(uint32_t h[5], const uint8_t* blk) {
  uint32_t x[16];
  for (int i = 0; i < 16; i++)
    x[i] = uint32_t(blk[4 * i]) | (uint32_t(blk[4 * i + 1]) << 8) |
           (uint32_t(blk[4 * i + 2]) << 16) | (uint32_t(blk[4 * i + 3]) << 24);
  uint32_t al = h[0], bl = h[1], cl = h[2], dl = h[3], el = h[4];
  uint32_t ar = h[0], br = h[1], cr = h[2], dr = h[3], er = h[4];
  for (int i = 0; i < 80; i++) {
    int rnd = i >> 4;
    uint32_t t = rol(al + fi(bl, cl, dl, rnd) + x[ML[i]] + KL[rnd], RL[i]) + el;
    al = el; el = dl; dl = rol(cl, 10); cl = bl; bl = t;
    t = rol(ar + fi(br, cr, dr, 4 - rnd) + x[MR[i]] + KR[rnd], RR[i]) + er;
    ar = er; er = dr; dr = rol(cr, 10); cr = br; br = t;
  }
  uint32_t t = h[1] + cl + dr;
  h[1] = h[2] + dl + er;
  h[2] = h[3] + el + ar;
  h[3] = h[4] + al + br;
  h[4] = h[0] + bl + cr;
  h[0] = t;
}

static void hash(const uint8_t* p, size_t n, uint8_t out[20]) {
  uint32_t h[5] = {0x67452301, 0xefcdab89, 0x98badcfe, 0x10325476, 0xc3d2e1f0};
  size_t full = n & ~size_t(63);
  for (size_t off = 0; off < full; off += 64) compress(h, p + off);
  uint8_t tail[128];
  size_t rem = n - full;
  memcpy(tail, p + full, rem);
  tail[rem] = 0x80;
  size_t padlen = (rem < 56) ? 64 : 128;
  memset(tail + rem + 1, 0, padlen - rem - 1 - 8);
  uint64_t bits = uint64_t(n) * 8;
  for (int i = 0; i < 8; i++) tail[padlen - 8 + i] = uint8_t(bits >> (8 * i));
  compress(h, tail);
  if (padlen == 128) compress(h, tail + 64);
  for (int i = 0; i < 5; i++) {
    out[4 * i] = uint8_t(h[i]);
    out[4 * i + 1] = uint8_t(h[i] >> 8);
    out[4 * i + 2] = uint8_t(h[i] >> 16);
    out[4 * i + 3] = uint8_t(h[i] >> 24);
  }
}

#ifdef TAPSTARK_AVX2
// Eight-lane RIPEMD-160 of 32-byte messages (one padded block per lane) —
// exactly the inner step of hash160. The scalar compression is ILP-limited
// (~2 ops/cycle across the two lines); eight lanes in AVX2 registers run the
// same rounds at ~8x block throughput.
static inline __m256i vrol(__m256i x, int n) {
  return _mm256_or_si256(_mm256_slli_epi32(x, n), _mm256_srli_epi32(x, 32 - n));
}

static inline __m256i vf(__m256i x, __m256i y, __m256i z, int i) {
  const __m256i ones = _mm256_set1_epi32(-1);
  switch (i) {
    case 0: return _mm256_xor_si256(_mm256_xor_si256(x, y), z);
    case 1:  // (x&y)|(~x&z) == ((y^z)&x)^z
      return _mm256_xor_si256(_mm256_and_si256(_mm256_xor_si256(y, z), x), z);
    case 2:  // (x|~y)^z
      return _mm256_xor_si256(
          _mm256_or_si256(x, _mm256_xor_si256(y, ones)), z);
    case 3:  // (x&z)|(y&~z) == ((x^y)&z)^y
      return _mm256_xor_si256(_mm256_and_si256(_mm256_xor_si256(x, y), z), y);
    default:  // x^(y|~z)
      return _mm256_xor_si256(
          x, _mm256_or_si256(y, _mm256_xor_si256(z, ones)));
  }
}

static void rmd_x8_digest32(const uint8_t dig[8][32], uint8_t out[8][20]) {
  __m256i x[16];
  // 32-byte message -> padded block: msg words, 0x80 marker, bitlen 256
  for (int j = 0; j < 8; j++) {
    uint32_t w[8];
    for (int l = 0; l < 8; l++) memcpy(&w[l], dig[l] + 4 * j, 4);
    x[j] = _mm256_set_epi32(w[7], w[6], w[5], w[4], w[3], w[2], w[1], w[0]);
  }
  x[8] = _mm256_set1_epi32(0x80);
  for (int j = 9; j < 14; j++) x[j] = _mm256_setzero_si256();
  x[14] = _mm256_set1_epi32(256);
  x[15] = _mm256_setzero_si256();

  const __m256i h0 = _mm256_set1_epi32(0x67452301);
  const __m256i h1 = _mm256_set1_epi32(0xefcdab89);
  const __m256i h2 = _mm256_set1_epi32(0x98badcfe);
  const __m256i h3 = _mm256_set1_epi32(0x10325476);
  const __m256i h4 = _mm256_set1_epi32(0xc3d2e1f0);
  __m256i al = h0, bl = h1, cl = h2, dl = h3, el = h4;
  __m256i ar = h0, br = h1, cr = h2, dr = h3, er = h4;

  for (int i = 0; i < 80; i++) {
    int rnd = i >> 4;
    __m256i t = _mm256_add_epi32(
        _mm256_add_epi32(al, vf(bl, cl, dl, rnd)),
        _mm256_add_epi32(x[ML[i]], _mm256_set1_epi32(KL[rnd])));
    t = _mm256_add_epi32(vrol(t, RL[i]), el);
    al = el; el = dl; dl = vrol(cl, 10); cl = bl; bl = t;
    t = _mm256_add_epi32(
        _mm256_add_epi32(ar, vf(br, cr, dr, 4 - rnd)),
        _mm256_add_epi32(x[MR[i]], _mm256_set1_epi32(KR[rnd])));
    t = _mm256_add_epi32(vrol(t, RR[i]), er);
    ar = er; er = dr; dr = vrol(cr, 10); cr = br; br = t;
  }

  __m256i o0 = _mm256_add_epi32(_mm256_add_epi32(h1, cl), dr);
  __m256i o1 = _mm256_add_epi32(_mm256_add_epi32(h2, dl), er);
  __m256i o2 = _mm256_add_epi32(_mm256_add_epi32(h3, el), ar);
  __m256i o3 = _mm256_add_epi32(_mm256_add_epi32(h4, al), br);
  __m256i o4 = _mm256_add_epi32(_mm256_add_epi32(h0, bl), cr);

  uint32_t ob[5][8];
  _mm256_storeu_si256((__m256i*)ob[0], o0);
  _mm256_storeu_si256((__m256i*)ob[1], o1);
  _mm256_storeu_si256((__m256i*)ob[2], o2);
  _mm256_storeu_si256((__m256i*)ob[3], o3);
  _mm256_storeu_si256((__m256i*)ob[4], o4);
  for (int l = 0; l < 8; l++)
    for (int w = 0; w < 5; w++) memcpy(out[l] + 4 * w, &ob[w][l], 4);
}
#endif  // TAPSTARK_AVX2

}  // namespace rmd160impl

static void hash160(const uint8_t* p, size_t n, uint8_t out[20]) {
  uint8_t s[32];
  sha256impl::hash(p, n, s);
  rmd160impl::hash(s, 32, out);
}

#if defined(TAPSTARK_AVX2)
// Eight hash160 lanes in lockstep: 4x two-stream sha256 (one padded block
// per lane) + one 8-lane ripemd160. blocks[l] is lane l's padded 64-byte
// sha256 block (message + 0x80 + bitlen already in place).
static void hash160_x8_blocks(const uint8_t blocks[8][64], uint8_t out[8][20]) {
  uint32_t st[8][8];
  for (int l = 0; l < 8; l++) memcpy(st[l], sha256impl::INIT, 32);
  for (int j = 0; j < 8; j += 2)
    sha256impl::sha_block2(st[j], st[j + 1], blocks[j], blocks[j + 1]);
  uint8_t dig[8][32];
  for (int l = 0; l < 8; l++) sha256impl::sha_digest(st[l], dig[l]);
  rmd160impl::rmd_x8_digest32(dig, out);
}
#endif

// ---------------------------------------------------------------------------
// Script helpers
// ---------------------------------------------------------------------------

// minimal CScriptNum push of a non-negative value < 2^31 (incl. opcode)
static size_t push_num(uint8_t* out, uint32_t v) {
  if (v == 0) { out[0] = 0x00; return 1; }          // OP_0
  if (v <= 16) { out[0] = 0x50 + uint8_t(v); return 1; }  // OP_1..OP_16
  uint8_t enc[5];
  size_t n = 0;
  uint32_t m = v;
  while (m) { enc[n++] = uint8_t(m & 0xff); m >>= 8; }
  if (enc[n - 1] & 0x80) enc[n++] = 0x00;
  out[0] = uint8_t(n);
  memcpy(out + 1, enc, n);
  return n + 1;
}

static void tagged_hash(const uint8_t tagdigest[32], const uint8_t* msg,
                        size_t n, uint8_t out[32]) {
  sha256impl::Ctx c;
  c.update(tagdigest, 32);
  c.update(tagdigest, 32);
  c.update(msg, n);
  c.final(out);
}

extern "C" {

// hash160 chains for Winternitz public keys.
// secrets: n * secret_len bytes; for each secret and each digit index
// 0..num_digits-1: h = hash160(secret || digit); repeat chain_extra more
// times; output n * num_digits * 20 bytes.
void winternitz_pubkeys_batch(const uint8_t* secrets, size_t n,
                              size_t secret_len, int num_digits,
                              int chain_extra, uint8_t* out) {
  size_t total = size_t(n) * num_digits;
  size_t g = 0;
#if defined(TAPSTARK_AVX2)
  // chains are independent: run 8 in lockstep (interleaved sha256 + 8-lane
  // ripemd160); each step's message is <= 55 bytes -> one padded sha block
  if (secret_len + 1 <= 55) {
    uint8_t blk[8][64];
    uint8_t h[8][20];
    for (; g + 8 <= total; g += 8) {
      for (int l = 0; l < 8; l++) {
        size_t chain = g + l;
        memset(blk[l], 0, 64);
        memcpy(blk[l], secrets + (chain / num_digits) * secret_len,
               secret_len);
        blk[l][secret_len] = uint8_t(chain % num_digits);
        blk[l][secret_len + 1] = 0x80;
        uint64_t bits = uint64_t(secret_len + 1) * 8;
        blk[l][62] = uint8_t(bits >> 8);
        blk[l][63] = uint8_t(bits);
      }
      hash160_x8_blocks(blk, h);
      for (int k = 0; k < chain_extra; k++) {
        for (int l = 0; l < 8; l++) {
          memset(blk[l], 0, 64);
          memcpy(blk[l], h[l], 20);
          blk[l][20] = 0x80;
          blk[l][63] = 160;
        }
        hash160_x8_blocks(blk, h);
      }
      for (int l = 0; l < 8; l++) memcpy(out + (g + l) * 20, h[l], 20);
    }
  }
#endif
  std::vector<uint8_t> buf(secret_len + 1);
  for (; g < total; g++) {
    memcpy(buf.data(), secrets + (g / num_digits) * secret_len, secret_len);
    buf[secret_len] = uint8_t(g % num_digits);
    uint8_t h[20];
    hash160(buf.data(), secret_len + 1, h);
    for (int k = 0; k < chain_extra; k++) hash160(h, 20, h);
    memcpy(out + g * 20, h, 20);
  }
}

// Winternitz digit signatures: chain g covers message m = g / num_digits,
// digit index i = g % num_digits, and walks digit_vals[g] steps past the
// chain start: out[g] = hash160^digit_vals[g](hash160(secret_m || i)).
// (The open path's witness generation; same 8-lane lockstep as keygen,
// with per-lane snapshots at each lane's stop step.)
void winternitz_sign_batch(const uint8_t* secrets, size_t n_msgs,
                           size_t secret_len, const uint8_t* digit_vals,
                           int num_digits, uint8_t* out) {
  size_t total = n_msgs * size_t(num_digits);
  size_t g = 0;
#if defined(TAPSTARK_AVX2)
  if (secret_len + 1 <= 55) {
    uint8_t blk[8][64];
    uint8_t h[8][20];
    for (; g + 8 <= total; g += 8) {
      int kmax = 0;
      for (int l = 0; l < 8; l++) {
        size_t chain = g + l;
        memset(blk[l], 0, 64);
        memcpy(blk[l], secrets + (chain / num_digits) * secret_len,
               secret_len);
        blk[l][secret_len] = uint8_t(chain % num_digits);
        blk[l][secret_len + 1] = 0x80;
        uint64_t bits = uint64_t(secret_len + 1) * 8;
        blk[l][62] = uint8_t(bits >> 8);
        blk[l][63] = uint8_t(bits);
        if (digit_vals[g + l] > kmax) kmax = digit_vals[g + l];
      }
      hash160_x8_blocks(blk, h);
      for (int l = 0; l < 8; l++)
        if (digit_vals[g + l] == 0) memcpy(out + (g + l) * 20, h[l], 20);
      for (int k = 1; k <= kmax; k++) {
        for (int l = 0; l < 8; l++) {
          memset(blk[l], 0, 64);
          memcpy(blk[l], h[l], 20);
          blk[l][20] = 0x80;
          blk[l][63] = 160;
        }
        hash160_x8_blocks(blk, h);
        for (int l = 0; l < 8; l++)
          if (digit_vals[g + l] == k) memcpy(out + (g + l) * 20, h[l], 20);
      }
    }
  }
#endif
  std::vector<uint8_t> buf(secret_len + 1);
  for (; g < total; g++) {
    memcpy(buf.data(), secrets + (g / num_digits) * secret_len, secret_len);
    buf[secret_len] = uint8_t(g % num_digits);
    uint8_t h[20];
    hash160(buf.data(), secret_len + 1, h);
    for (int k = 0; k < digit_vals[g]; k++) hash160(h, 20, h);
    memcpy(out + g * 20, h, 20);
  }
}

void sha256_batch(const uint8_t* data, const uint64_t* offsets, size_t n,
                  uint8_t* out) {
  for (size_t i = 0; i < n; i++)
    sha256impl::hash(data + offsets[i], offsets[i + 1] - offsets[i],
                     out + 32 * i);
}

// Midstates: from a caller-supplied 8-word chaining state (e.g. a BIP-341
// tag midstate), compress msg_len/64 full blocks of each fixed-length
// message; out = n_msgs x 8 state words. Feeds the device taptree commit's
// per-repetition head midstates (a few hundred KB of SHA total — host
// SHA-NI finishes in microseconds where a 28-lane device scan through a
// remote relay costs seconds).
void sha256_midstates(const uint8_t* msgs, size_t n_msgs, size_t msg_len,
                      const uint32_t* init_state, uint32_t* out) {
  size_t nb = msg_len / 64;
  for (size_t i = 0; i < n_msgs; i++) {
    uint32_t h[8];
    memcpy(h, init_state, 32);
    const uint8_t* p = msgs + i * msg_len;
    for (size_t b = 0; b < nb; b++) sha256impl::sha_block(h, p + b * 64);
    memcpy(out + i * 8, h, 32);
  }
}

// Sparse TCS commit.
//
// Leaf i script (constant-head layout) = head || tail(i) || OP_NOP pad to
// fixed_len, where head = all Winternitz locks (parking recovered limbs on
// the altstack) and tail(i) = for each value in reverse, for limb 0..n-1:
//   push(limb) OP_FROMALTSTACK OP_EQUALVERIFY, then push(i) 0x6c 0x88 OP_1.
// Because fixed_len is shard-wide, the tapleaf preimage prefix
// (tag||tag || leaf_version || compact_size(fixed_len) || head) is shared:
// its midstate is computed once and each leaf costs only the ~2 blocks of
// (prefix remainder || tail || pad). The reference rehashes the multi-KB
// lock bytes per leaf (basic/src/tcs/mod.rs:197-226).
//
// MEMORY-LEAN DESIGN: the commit emits ONLY the level hash arrays at or
// above `cutoff` (L_cutoff .. L_{depth-1}, ~n/2^cutoff entries total) plus
// the root. Leaf hashes and the bottom levels live in thread-local scratch
// that is reused across calls (query repetitions / FRI layers) — the
// dominant commit allocation (n x 32B leaf hashes + n x 32B levels, GBs at
// 2^20-row configs) never persists. An opening recomputes its leaf's
// 2^cutoff-leaf block with tcs_leaf_block (a few hundred compressions) and
// takes the upper siblings from the stored arrays. Branch of leaf i =
// [S_l[block-local sibling] for l < cutoff] ++ [L_l[(i>>l)^1] for l >=
// cutoff]: the ordered (BIP-341 lexicographic) pair sort affects only each
// parent's preimage order, never the position-indexed hash arrays, so no
// permutation bookkeeping is needed (verification re-sorts per step).

namespace tcsimpl {

struct LeafHasher {
  // shared midstate over tag||tag || leaf_version || csize(fixed_len) ||
  // full head blocks; per-leaf work = rem bytes || tail region || sha pad.
  uint32_t leafmid[8];
  size_t rem;               // head prefix bytes left after full blocks
  const uint8_t* remp;      // pointer into prefix storage
  std::vector<uint8_t> prefix;
  size_t tail_region;       // fixed_len - head_len (tail + NOP pad)
  size_t L;                 // message bytes after the midstate
  size_t Pb;                // padded length (multiple of 64)
  size_t nblocks;
  uint64_t bits;
  const uint32_t* values;   // rows at ABSOLUTE leaf index
  uint32_t num_values, num_limbs;

  LeafHasher(const uint8_t* head, uint64_t head_len, uint64_t fixed_len,
             const uint32_t* values_, uint32_t num_values_,
             uint32_t num_limbs_, const uint8_t* tapleaf_tag,
             uint8_t leaf_version)
      : values(values_), num_values(num_values_), num_limbs(num_limbs_) {
    memcpy(leafmid, sha256impl::INIT, 32);
    uint8_t tagblk[64];
    memcpy(tagblk, tapleaf_tag, 32);
    memcpy(tagblk + 32, tapleaf_tag, 32);
    sha256impl::sha_block(leafmid, tagblk);
    prefix.push_back(leaf_version);
    if (fixed_len < 0xfd) {
      prefix.push_back(uint8_t(fixed_len));
    } else if (fixed_len <= 0xffff) {
      prefix.push_back(0xfd);
      prefix.push_back(uint8_t(fixed_len & 0xff));
      prefix.push_back(uint8_t(fixed_len >> 8));
    } else {
      prefix.push_back(0xfe);
      for (int b = 0; b < 4; b++)
        prefix.push_back(uint8_t(fixed_len >> (8 * b)));
    }
    prefix.insert(prefix.end(), head, head + head_len);
    size_t full = prefix.size() / 64;
    for (size_t k = 0; k < full; k++)
      sha256impl::sha_block(leafmid, prefix.data() + 64 * k);
    rem = prefix.size() % 64;
    remp = prefix.data() + 64 * full;
    tail_region = size_t(fixed_len) - size_t(head_len);
    L = rem + tail_region;
    Pb = (L + 9 + 63) & ~size_t(63);
    nblocks = Pb / 64;
    bits = (uint64_t(64) + prefix.size() + tail_region) * 8;
  }

  void init_buf(uint8_t* ob) const {
    memcpy(ob, remp, rem);
    ob[L] = 0x80;
    memset(ob + L + 1, 0, Pb - L - 1 - 8);
    for (int b = 0; b < 8; b++) ob[Pb - 8 + b] = uint8_t(bits >> (56 - 8 * b));
  }

  // write tail(i) + NOP pad into the tail region (i = absolute leaf index)
  void assemble(uint32_t i, uint8_t* ob) const {
    const uint32_t* row = values + size_t(i) * num_values * num_limbs;
    size_t off = rem;
    for (int v = int(num_values) - 1; v >= 0; v--) {
      for (uint32_t limb = 0; limb < num_limbs; limb++) {
        off += push_num(ob + off, row[size_t(v) * num_limbs + limb]);
        ob[off++] = 0x6c;  // OP_FROMALTSTACK
        ob[off++] = 0x88;  // OP_EQUALVERIFY
      }
    }
    off += push_num(ob + off, i);
    ob[off++] = 0x6c;
    ob[off++] = 0x88;
    ob[off++] = 0x51;  // OP_1
    memset(ob + off, 0x61, rem + tail_region - off);  // OP_NOP pad
  }

  // hash leaves [base, base + count) into out (count * 32 bytes), two
  // interleaved SHA-NI streams.
  void hash_range(uint32_t base, uint32_t count, uint8_t* out) const {
    std::vector<uint8_t> bufa(Pb), bufb(Pb);
    init_buf(bufa.data());
    init_buf(bufb.data());
    uint32_t j = 0;
    for (; j + 1 < count; j += 2) {
      assemble(base + j, bufa.data());
      assemble(base + j + 1, bufb.data());
      uint32_t hA[8], hB[8];
      memcpy(hA, leafmid, 32);
      memcpy(hB, leafmid, 32);
      for (size_t k = 0; k < nblocks; k++)
        sha256impl::sha_block2(hA, hB, bufa.data() + 64 * k,
                               bufb.data() + 64 * k);
      sha256impl::sha_digest(hA, out + 32 * size_t(j));
      sha256impl::sha_digest(hB, out + 32 * size_t(j + 1));
    }
    for (; j < count; j++) {
      assemble(base + j, bufa.data());
      uint32_t hA[8];
      memcpy(hA, leafmid, 32);
      for (size_t k = 0; k < nblocks; k++)
        sha256impl::sha_block(hA, bufa.data() + 64 * k);
      sha256impl::sha_digest(hA, out + 32 * size_t(j));
    }
  }
};

struct BranchHasher {
  uint32_t branchmid[8];
  uint8_t padb[64];  // constant second block: 0x80 pad, bitlen 1024

  explicit BranchHasher(const uint8_t* tapbranch_tag) {
    memcpy(branchmid, sha256impl::INIT, 32);
    uint8_t tagblk[64];
    memcpy(tagblk, tapbranch_tag, 32);
    memcpy(tagblk + 32, tapbranch_tag, 32);
    sha256impl::sha_block(branchmid, tagblk);
    memset(padb, 0, 64);
    padb[0] = 0x80;
    padb[62] = 0x04;  // bitlen = (64 tag + 64 msg) * 8 = 1024, BE
  }

  // one level: parent k = tagged(TapBranch, sort(child 2k, child 2k+1));
  // position-indexed (the sort touches only the preimage order).
  void level(const uint8_t* children, uint32_t count, uint8_t* parents,
             std::vector<uint8_t>& pin) const {
    uint32_t np = count / 2;
    pin.resize(size_t(np) * 64);
    for (uint32_t k = 0; k + 1 < count; k += 2) {
      const uint8_t* ha = children + size_t(k) * 32;
      const uint8_t* hb = children + size_t(k + 1) * 32;
      uint8_t* dst = pin.data() + size_t(k / 2) * 64;
      if (memcmp(ha, hb, 32) <= 0) {
        memcpy(dst, ha, 32);
        memcpy(dst + 32, hb, 32);
      } else {
        memcpy(dst, hb, 32);
        memcpy(dst + 32, ha, 32);
      }
    }
    uint32_t pj = 0;
    for (; pj + 1 < np; pj += 2) {
      uint32_t hJ[8], hK[8];
      memcpy(hJ, branchmid, 32);
      memcpy(hK, branchmid, 32);
      sha256impl::sha_block2(hJ, hK, pin.data() + size_t(pj) * 64,
                             pin.data() + size_t(pj + 1) * 64);
      sha256impl::sha_block2(hJ, hK, padb, padb);
      sha256impl::sha_digest(hJ, parents + size_t(pj) * 32);
      sha256impl::sha_digest(hK, parents + size_t(pj) * 32 + 32);
    }
    for (; pj < np; pj++) {
      uint32_t hJ[8];
      memcpy(hJ, branchmid, 32);
      sha256impl::sha_block(hJ, pin.data() + size_t(pj) * 64);
      sha256impl::sha_block(hJ, padb);
      sha256impl::sha_digest(hJ, parents + size_t(pj) * 32);
    }
  }
};

// thread-local scratch reused across commits: the bottom-of-tree hash
// arrays never persist and never re-fault fresh pages.
thread_local std::vector<uint8_t> g_scratch_a;
thread_local std::vector<uint8_t> g_scratch_b;
thread_local std::vector<uint8_t> g_scratch_pin;

}  // namespace tcsimpl

// Sparse TCS commit: hash every tapleaf from the shard's shared SHA-256
// midstate, build the taptree in reusable thread-local scratch, and emit
// only the root plus the level hash arrays at or above `cutoff`
// (upper_levels = concat of L_cutoff .. L_{depth-1}; sizes n>>cutoff down
// to 2; empty when depth <= cutoff).
void tcs_commit_sparse(const uint8_t* head, uint64_t head_len,
                       uint64_t fixed_len, const uint32_t* values,
                       uint32_t num_leaves, uint32_t num_values,
                       uint32_t num_limbs, const uint8_t* tapleaf_tag,
                       const uint8_t* tapbranch_tag, uint8_t leaf_version,
                       uint32_t cutoff, uint8_t* root, uint8_t* upper_levels) {
  using namespace tcsimpl;
  LeafHasher lh(head, head_len, fixed_len, values, num_values, num_limbs,
                tapleaf_tag, leaf_version);
  g_scratch_a.resize(size_t(num_leaves) * 32);
  lh.hash_range(0, num_leaves, g_scratch_a.data());
  if (num_leaves == 1) {
    memcpy(root, g_scratch_a.data(), 32);
    return;
  }
  BranchHasher bh(tapbranch_tag);
  g_scratch_b.resize(size_t(num_leaves) * 16);
  uint8_t* cur = g_scratch_a.data();
  uint8_t* nxt = g_scratch_b.data();
  uint32_t count = num_leaves;
  uint32_t lvl = 0;
  while (count > 1) {
    bh.level(cur, count, nxt, g_scratch_pin);
    count /= 2;
    lvl++;
    if (count > 1 && lvl >= cutoff) {
      memcpy(upper_levels, nxt, size_t(count) * 32);
      upper_levels += size_t(count) * 32;
    }
    uint8_t* t = cur;
    cur = nxt;
    nxt = t;
  }
  memcpy(root, cur, 32);
}

// Rebuild one 2^k-leaf block for an opening: leaf hashes (absolute indices
// [base, base+block_n)) followed by every sub-level up to the block root.
// out layout: S_0 (block_n x 32) || S_1 (block_n/2 x 32) || ... || S_k (32).
// values points at the BLOCK's first row (caller slices).
void tcs_leaf_block(const uint8_t* head, uint64_t head_len,
                    uint64_t fixed_len, const uint32_t* values,
                    uint32_t base_index, uint32_t block_n,
                    uint32_t num_values, uint32_t num_limbs,
                    const uint8_t* tapleaf_tag, const uint8_t* tapbranch_tag,
                    uint8_t leaf_version, uint8_t* out) {
  using namespace tcsimpl;
  // shift values back so LeafHasher's absolute-index row lookup lands on
  // the caller's block slice
  const uint32_t* vbase =
      values - size_t(base_index) * num_values * num_limbs;
  LeafHasher lh(head, head_len, fixed_len, vbase, num_values, num_limbs,
                tapleaf_tag, leaf_version);
  lh.hash_range(base_index, block_n, out);
  if (block_n == 1) return;
  BranchHasher bh(tapbranch_tag);
  std::vector<uint8_t> pin;
  uint8_t* cur = out;
  uint32_t count = block_n;
  while (count > 1) {
    uint8_t* nxt = cur + size_t(count) * 32;
    bh.level(cur, count, nxt, pin);
    cur = nxt;
    count /= 2;
  }
}

}  // extern "C"

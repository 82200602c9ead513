// Host-side record codec: single-pass tokenizer + dual-lane FNV-1a hasher.
//
// The TPU compute path (XLA/segment kernels) starts from token hash lanes;
// producing those lanes from raw text is host work that pure numpy does in
// several passes (class lookup, boundary scan, padded gather, column-wise
// FNV).  This C++ pass fuses all of it: one walk over the chunk buffer emits
// token offsets, lengths, and both hash lanes.  This is the framework's
// native "host I/O layer" component (SURVEY §7.2): the reference is pure
// Python end-to-end, so there is no reference counterpart to mirror — the
// design target is simply to outrun the TPU feed.
//
// Hash compatibility: lanes MUST match ops/hashing.py exactly
// (_FNV_OFFSET1/2, _FNV_PRIME1/2 over utf-8 bytes) so tokens group with
// equal Python-string keys everywhere in the engine.
//
// Build: g++ -O3 -march=native -shared -fPIC tokenizer.cpp -o _native.so

#include <cstdint>
#include <cstdlib>
#include <cstring>

#if defined(__x86_64__)
#include <immintrin.h>  // _mm_prefetch everywhere; AVX-512 used when built
#endif

extern "C" {

// Token classification modes (keep in sync with dampr_tpu/ops/text.py):
//   mode 0: whitespace-delimited (str.split semantics, ASCII whitespace)
//   mode 1: word characters [0-9A-Za-z_] + bytes >= 128 (re [^\w]+ on ASCII)
// Table-driven: one L1-resident lookup per byte beats the range-compare
// chain in the hot scan.
struct ClassTables {
    bool tok[2][256];
    uint8_t fold[2][256];  // [lower?][byte] -> case-folded byte
    ClassTables() {
        for (int b = 0; b < 256; ++b) {
            tok[0][b] = !(b == ' ' || b == '\t' || b == '\n' || b == '\r' ||
                          b == '\v' || b == '\f');
            tok[1][b] = (b >= '0' && b <= '9') || (b >= 'A' && b <= 'Z') ||
                        (b >= 'a' && b <= 'z') || b == '_' || b >= 128;
            fold[0][b] = (uint8_t)b;
            fold[1][b] = (b >= 'A' && b <= 'Z') ? (uint8_t)(b + 32)
                                                : (uint8_t)b;
        }
    }
};
static const ClassTables kTables;

// Single pass: tokenize + hash + (optional) lowercase folding into the hash.
// Returns the number of tokens found.  Output arrays must hold at least
// n/2 + 1 entries (the worst case: alternating token/separator bytes).
// line_ids receives the 0-based line index of each token (newlines counted
// in the raw buffer) — pass nullptr to skip.
long dampr_tokenize_hash(const uint8_t* buf, long n, int mode, int lower,
                         int64_t* starts, int32_t* lens,
                         uint32_t* h1_out, uint32_t* h2_out,
                         int64_t* line_ids) {
    const uint32_t OFF1 = 2166136261u, OFF2 = 0x9747B28Cu;
    const uint32_t P1 = 16777619u, P2 = 0x85EBCA6Bu;

    const uint8_t* fold = kTables.fold[lower ? 1 : 0];
    const bool* tokt = kTables.tok[mode ? 1 : 0];
    long count = 0;
    long i = 0;
    int64_t line = 0;
    while (i < n) {
        uint8_t b = buf[i];
        if (b == '\n') { ++line; ++i; continue; }
        if (!tokt[b]) { ++i; continue; }
        // token run
        long s = i;
        uint32_t h1 = OFF1, h2 = OFF2;
        int64_t tok_line = line;
        do {
            uint8_t c = fold[buf[i]];
            h1 = (h1 ^ c) * P1;
            h2 = (h2 ^ c) * P2;
            ++i;
        } while (i < n && tokt[buf[i]]);
        starts[count] = s;
        lens[count] = (int32_t)(i - s);
        h1_out[count] = h1;
        h2_out[count] = h2;
        if (line_ids) line_ids[count] = tok_line;
        ++count;
    }
    return count;
}

// Fused tokenize + hash + count: one pass over the buffer feeding an
// open-addressing table keyed on the 64-bit hash pair *verified by byte
// comparison* — a probe hit requires equal hashes AND equal token bytes
// (case-folded when lower is set), so distinct tokens colliding in all 64
// hash bits occupy separate slots and are never silently merged.  (They then
// emit separate entries sharing (h1, h2); the engine's sort-based grouping
// repairs exactly that shape downstream by comparing real keys.)
//
// Emits one entry per distinct token: (h1, h2, count, representative
// offset/len).  With dedup_per_line != 0 a token increments at most once per
// newline-delimited line (document frequency — the reference TF-IDF
// benchmark's map+count, tf-idf-dampr.py:13-15).
//
// Returns the number of distinct tokens (<= out array capacity n/2+1), or -1
// on allocation failure.

// Byte equality of the tails past the inline 8-byte prefix (folded when
// lower is set).  Only runs for tokens longer than 8 bytes whose hashes,
// length, and prefix all matched — rare, so the random buffer access it
// costs is off the hot path.
static inline bool tail_eq(const uint8_t* buf, int64_t a, int64_t b,
                           int32_t len, int lower) {
    if (!lower) return memcmp(buf + a + 8, buf + b + 8, (size_t)(len - 8)) == 0;
    for (int32_t i = 8; i < len; ++i) {
        uint8_t x = buf[a + i], y = buf[b + i];
        if (x >= 'A' && x <= 'Z') x += 32;
        if (y >= 'A' && y <= 'Z') y += 32;
        if (x != y) return false;
    }
    return true;
}
// Probe-hash mix of the per-token summary words.  This is NOT the FNV
// lanes the engine sees — equality at the table is byte-verified, so the
// probe hash only has to spread slots, and one 64-bit multiply per token
// replaces the old two-multiplies-per-byte FNV in the scan loop.  The
// exact FNV lanes are recomputed at emit time for the (few) distinct
// tokens only.
static inline uint64_t probe_mix(uint64_t prefix, uint64_t tailw,
                                 int32_t len) {
    uint64_t ph = prefix ^ (tailw * 0xC2B2AE3D27D4EB4FULL);
    ph ^= (uint64_t)(uint32_t)len * 0x9E3779B97F4A7C15ULL;
    ph *= 0xFF51AFD7ED558CCDULL;
    ph ^= ph >> 33;
    return ph;
}

// Table state for the counting pass, split out so the scalar and SIMD scan
// drivers share one probe/insert/grow path.
struct CountTable {
    struct Entry {
        uint64_t prefix;    // first <=8 folded bytes, zero-padded
        uint64_t tailw;     // last 8 folded bytes when len > 8, else 0
        int64_t count;
        int64_t start;      // representative occurrence (first seen)
        int64_t last_line;  // for per-line dedup; -1 = never seen
        int32_t len;
        uint32_t tag;       // high probe-hash bits | 1; 0 = empty slot
    };
    Entry* tbl;
    long cap;
    long used;
    bool oom;
};

// SWAR case-fold of 8 packed bytes: ASCII A-Z += 0x20, all other bytes
// (including >= 0x80) unchanged — bitwise identical to kTables.fold[1].
static inline uint64_t fold8(uint64_t w) {
    const uint64_t kOnes = 0x0101010101010101ULL;
    const uint64_t kHigh = 0x8080808080808080ULL;
    uint64_t hi = w & kHigh;
    uint64_t w7 = w & ~kHigh;
    uint64_t ge_a = (w7 + (0x80 - 'A') * kOnes) & kHigh;  // byte >= 'A'
    uint64_t gt_z = (w7 + (0x7F - 'Z') * kOnes) & kHigh;  // byte >  'Z'
    uint64_t is_upper = (ge_a & ~gt_z) & ~hi;
    return w + (is_upper >> 2);  // 0x80 >> 2 == 0x20
}

static inline uint64_t load8(const uint8_t* p) {
    uint64_t w;
    memcpy(&w, p, 8);
    return w;
}

// Folded (prefix, tailw) summary words of token [s, s+len).
static inline void summarize_token(const uint8_t* buf, long n, int lower,
                                   const uint8_t* fold, long s, int32_t len,
                                   uint64_t* out_prefix, uint64_t* out_tailw) {
    uint64_t prefix;
    if (len >= 8) {
        prefix = load8(buf + s);
        prefix = lower ? fold8(prefix) : prefix;
    } else if (s + 8 <= n) {
        prefix = load8(buf + s) & ((1ULL << (len * 8)) - 1);
        prefix = lower ? fold8(prefix) : prefix;
    } else {
        prefix = 0;  // token at the very end of the buffer: bytewise
        for (int j = 0; j < len; ++j)
            prefix |= ((uint64_t)fold[buf[s + j]]) << (j * 8);
    }
    uint64_t tailw = 0;
    if (len > 8) {
        tailw = load8(buf + s + len - 8);
        tailw = lower ? fold8(tailw) : tailw;
    }
    *out_prefix = prefix;
    *out_tailw = tailw;
}

// Double the table when load passes 70% (callers ensure headroom for the
// occurrences they are about to insert).
static inline void maybe_grow(CountTable* T, long incoming) {
    if (T->oom) return;  // don't retry a failed multi-MB calloc per token
    if ((T->used + incoming) * 10 < T->cap * 7) return;
    long ncap = T->cap * 2;
    CountTable::Entry* nt =
        (CountTable::Entry*)calloc(ncap, sizeof(CountTable::Entry));
    if (!nt) { T->oom = true; return; }
    for (long j = 0; j < T->cap; ++j) {
        if (!T->tbl[j].tag) continue;
        uint64_t h = probe_mix(T->tbl[j].prefix, T->tbl[j].tailw,
                               T->tbl[j].len);
        long k = (long)(h & (uint64_t)(ncap - 1));
        while (nt[k].tag) k = (k + 1) & (ncap - 1);
        nt[k] = T->tbl[j];
    }
    free(T->tbl);
    T->tbl = nt;
    T->cap = ncap;
}

// Probe/insert/count one summarized occurrence.  The caller has already
// handled growth (so batched callers can prefetch slots safely).
static inline void probe_token(CountTable* T, const uint8_t* buf,
                               int lower, int dedup_per_line,
                               long s, int32_t len, int64_t line,
                               uint64_t prefix, uint64_t tailw, uint64_t ph) {
    CountTable::Entry* tbl = T->tbl;
    long cap_tbl = T->cap;
    uint32_t tag = (uint32_t)(ph >> 32) | 1u;
    long k = (long)(ph & (uint64_t)(cap_tbl - 1));
    while (tbl[k].tag &&
           !(tbl[k].tag == tag && tbl[k].len == len &&
             tbl[k].prefix == prefix && tbl[k].tailw == tailw &&
             (len <= 16 || tail_eq(buf, tbl[k].start, s, len, lower))))
        k = (k + 1) & (cap_tbl - 1);
    if (!tbl[k].tag) {
        tbl[k].tag = tag;
        tbl[k].prefix = prefix;
        tbl[k].tailw = tailw;
        tbl[k].count = 0;
        tbl[k].start = s;
        tbl[k].len = len;
        tbl[k].last_line = -1;
        ++T->used;
    }
    if (dedup_per_line) {
        if (tbl[k].last_line != line) {
            tbl[k].last_line = line;
            tbl[k].count += 1;
        }
    } else {
        tbl[k].count += 1;
    }
}

// One token occurrence [s, s+len) on line `line`: summarize, grow, probe.
static inline void count_token(CountTable* T, const uint8_t* buf, long n,
                               int lower, int dedup_per_line,
                               long s, int32_t len, int64_t line) {
    const uint8_t* fold = kTables.fold[lower ? 1 : 0];
    uint64_t prefix, tailw;
    summarize_token(buf, n, lower, fold, s, len, &prefix, &tailw);
    maybe_grow(T, 1);
    if (T->oom) return;
    probe_token(T, buf, lower, dedup_per_line, s, len, line,
                prefix, tailw, probe_mix(prefix, tailw, len));
}

#if defined(__AVX512BW__)
// 64-byte classification: token-char and newline bitmasks (bit j = byte j).
// Bits at or past `nb` (short final block) read as separators.
static inline void classify64(const uint8_t* p, int nb, int mode,
                              uint64_t* tokm, uint64_t* nlm) {
    __mmask64 lm = nb >= 64 ? ~(__mmask64)0 : (((__mmask64)1 << nb) - 1);
    __m512i v = _mm512_maskz_loadu_epi8(lm, p);
    __mmask64 nl = _mm512_cmpeq_epi8_mask(v, _mm512_set1_epi8('\n')) & lm;
    __mmask64 tok;
    if (mode) {
        // word chars: [0-9A-Za-z_] plus any byte >= 0x80
        __m512i low = _mm512_or_si512(v, _mm512_set1_epi8(0x20));
        __mmask64 alpha = _mm512_cmp_epu8_mask(
            _mm512_sub_epi8(low, _mm512_set1_epi8('a')),
            _mm512_set1_epi8(25), _MM_CMPINT_LE);
        __mmask64 digit = _mm512_cmp_epu8_mask(
            _mm512_sub_epi8(v, _mm512_set1_epi8('0')),
            _mm512_set1_epi8(9), _MM_CMPINT_LE);
        __mmask64 us = _mm512_cmpeq_epi8_mask(v, _mm512_set1_epi8('_'));
        __mmask64 hib = _mm512_movepi8_mask(v);  // sign bit = byte >= 0x80
        tok = alpha | digit | us | hib;
    } else {
        // whitespace-delimited: token = not in " \t\n\r\v\f"
        __mmask64 ws =
            _mm512_cmpeq_epi8_mask(v, _mm512_set1_epi8(' ')) |
            _mm512_cmpeq_epi8_mask(v, _mm512_set1_epi8('\t')) | nl |
            _mm512_cmpeq_epi8_mask(v, _mm512_set1_epi8('\r')) |
            _mm512_cmpeq_epi8_mask(v, _mm512_set1_epi8('\v')) |
            _mm512_cmpeq_epi8_mask(v, _mm512_set1_epi8('\f'));
        tok = ~ws;
    }
    *tokm = tok & lm;
    *nlm = nl;
}

// One-time cross-check of the intrinsic classifier against kTables (the
// single source of truth shared with the scalar paths and ops/text.py):
// every byte value, both modes.  On divergence the SIMD path refuses
// (callers fall back to numpy — slower, never wrong).
static bool classify64_selfcheck() {
    uint8_t all[256];
    for (int b = 0; b < 256; ++b) all[b] = (uint8_t)b;
    for (int mode = 0; mode < 2; ++mode) {
        for (int base = 0; base < 256; base += 64) {
            uint64_t tokm, nlm;
            classify64(all + base, 64, mode, &tokm, &nlm);
            for (int j = 0; j < 64; ++j) {
                int b = base + j;
                bool want_tok = kTables.tok[mode][b];
                bool want_nl = (b == '\n');
                if (((tokm >> j) & 1) != (want_tok ? 1u : 0u)) return false;
                if (((nlm >> j) & 1) != (want_nl ? 1u : 0u)) return false;
            }
        }
    }
    return true;
}
#endif  // __AVX512BW__

long dampr_token_counts(const uint8_t* buf, long n, int mode, int lower,
                        int dedup_per_line,
                        uint32_t* out_h1, uint32_t* out_h2,
                        int64_t* out_count,
                        int64_t* out_start, int32_t* out_len) {
    const uint32_t OFF1 = 2166136261u, OFF2 = 0x9747B28Cu;
    const uint32_t P1 = 16777619u, P2 = 0x85EBCA6Bu;

    CountTable T;
    T.cap = 1 << 16;
    T.tbl = (CountTable::Entry*)calloc(T.cap, sizeof(CountTable::Entry));
    T.used = 0;
    T.oom = false;
    if (!T.tbl) return -1;

    const uint8_t* fold = kTables.fold[lower ? 1 : 0];

#if defined(__AVX512BW__)
    static const bool kSimdOk = classify64_selfcheck();
    if (!kSimdOk) { free(T.tbl); return -1; }  // numpy fallback, never wrong
    // Block scan: classify 64 bytes into bitmasks, then walk token runs
    // with tzcnt — no per-byte branches, so short tokens stop costing a
    // mispredict each (measured 2x on the 4-byte-average Zipf corpus).
    int in_token = 0;
    long tok_start = 0;
    int64_t tok_line = 0;
    int64_t line = 0;
    for (long base = 0; base < n && !T.oom; base += 64) {
        int nb = (n - base) >= 64 ? 64 : (int)(n - base);
        uint64_t t, nlm;
        classify64(buf + base, nb, mode, &t, &nlm);
        if (in_token) {
            if (t == ~0ULL) continue;  // token spans the whole block
            int e = __builtin_ctzll(~t);
            count_token(&T, buf, n, lower, dedup_per_line, tok_start,
                        (int32_t)(base + e - tok_start), tok_line);
            in_token = 0;
            if (e > 0) t &= ~(((uint64_t)1 << e) - 1);
        }
        while (t) {
            int s = __builtin_ctzll(t);
            uint64_t run = ~(t >> s);  // first zero past s = run end
            // run == 0 (ones all the way to bit 63) must not reach
            // ctzll(0), which is undefined: treat as run-to-edge.
            int rl = run ? __builtin_ctzll(run) : (64 - s);
            int64_t at_line =
                line + __builtin_popcountll(
                           s ? (nlm & (((uint64_t)1 << s) - 1)) : 0);
            if (s + rl >= 64) {
                // run touches the block edge: may continue next block
                in_token = 1;
                tok_start = base + s;
                tok_line = at_line;
                break;
            }
            count_token(&T, buf, n, lower, dedup_per_line, base + s,
                        (int32_t)rl, at_line);
            t &= ~(((uint64_t)1 << (s + rl)) - 1);
        }
        line += __builtin_popcountll(nlm);
    }
    if (in_token)
        count_token(&T, buf, n, lower, dedup_per_line, tok_start,
                    (int32_t)(n - tok_start), tok_line);
#else
    // Scalar fallback (build without AVX-512): per-byte boundary scan.
    const bool* tokt = kTables.tok[mode ? 1 : 0];
    long i = 0;
    int64_t line = 0;
    while (i < n && !T.oom) {
        uint8_t b = buf[i];
        if (b == '\n') { ++line; ++i; continue; }
        if (!tokt[b]) { ++i; continue; }
        long s = i;
        do { ++i; } while (i < n && tokt[buf[i]]);
        count_token(&T, buf, n, lower, dedup_per_line, s,
                    (int32_t)(i - s), line);
    }
#endif
    if (T.oom) { free(T.tbl); return -1; }

    // Emit: the exact engine FNV lanes, computed once per DISTINCT token
    // from its representative bytes (folded identically to the scan).
    long out = 0;
    for (long j = 0; j < T.cap; ++j) {
        if (!T.tbl[j].tag) continue;
        uint32_t h1 = OFF1, h2 = OFF2;
        const int64_t s = T.tbl[j].start;
        for (int32_t p = 0; p < T.tbl[j].len; ++p) {
            uint8_t c = fold[buf[s + p]];
            h1 = (h1 ^ c) * P1;
            h2 = (h2 ^ c) * P2;
        }
        out_h1[out] = h1;
        out_h2[out] = h2;
        out_count[out] = T.tbl[j].count;
        out_start[out] = s;
        out_len[out] = T.tbl[j].len;
        ++out;
    }
    free(T.tbl);
    return out;
}

// Whitespace-separated signed int64 parse (the external-sort ingest hot
// path): one pass emits values; any token that is not a fully-valid
// in-range integer sets *bad to its index and stops, so the Python caller
// can re-raise with numpy's exact error semantics.  Matches
// np.array(data.split(), dtype=int64) for valid input.
long dampr_parse_i64(const uint8_t* buf, long n, int64_t* out, long* bad) {
    long count = 0;
    long i = 0;
    *bad = -1;
    const uint64_t kCut = (uint64_t)1 << 63;  // |INT64_MIN|
    while (i < n) {
        uint8_t b = buf[i];
        if (b == ' ' || b == '\t' || b == '\n' || b == '\r' || b == '\v' ||
            b == '\f') {
            ++i;
            continue;
        }
        bool neg = false;
        if (b == '-' || b == '+') {
            neg = (b == '-');
            ++i;
        }
        uint64_t v = 0;
        long digits = 0;
        while (i < n) {
            uint8_t c = buf[i];
            if (c >= '0' && c <= '9') {
                uint64_t nv = v * 10u + (uint64_t)(c - '0');
                if (v > (kCut / 10u) || nv < v) { *bad = count; return count; }
                v = nv;
                ++digits;
                ++i;
            } else if (c == ' ' || c == '\t' || c == '\n' || c == '\r' ||
                       c == '\v' || c == '\f') {
                break;
            } else {
                *bad = count;  // junk inside the token
                return count;
            }
        }
        if (digits == 0 || v > (neg ? kCut : kCut - 1)) {
            *bad = count;
            return count;
        }
        out[count++] = neg ? (int64_t)(~v + 1u) : (int64_t)v;
    }
    return count;
}

// Batch dual-lane FNV over concatenated key bytes: key i is
// buf[offs[i], offs[i+1]).  The host-side hash for string keys that did
// not come from the tokenizer (re-keyed records, group keys, canonical
// object encodings): one C pass replaces numpy's column-by-column matrix
// scan.  Lanes match ops/hashing.py exactly.
void dampr_hash_bytes_batch(const uint8_t* buf, const int64_t* offs,
                            long n_keys, uint32_t* h1_out,
                            uint32_t* h2_out) {
    const uint32_t OFF1 = 2166136261u, OFF2 = 0x9747B28Cu;
    const uint32_t P1 = 16777619u, P2 = 0x85EBCA6Bu;
    for (long i = 0; i < n_keys; ++i) {
        uint32_t h1 = OFF1, h2 = OFF2;
        for (int64_t j = offs[i]; j < offs[i + 1]; ++j) {
            uint8_t c = buf[j];
            h1 = (h1 ^ c) * P1;
            h2 = (h2 ^ c) * P2;
        }
        h1_out[i] = h1;
        h2_out[i] = h2;
    }
}

}  // extern "C"

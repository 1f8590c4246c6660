// yaik_host: native host runtime for yaik_tpu.
//
// The sequential, data-dependent stages that sit poorly in Python AND on the
// accelerator: the palette codec (reference PaletteCompressor/Decompressor
// semantics, EncoderContext.cpp:3259-3502 / YAIK_GenericFunctions.cpp:139-241)
// and the 1D residual pass (DynamicTileCompressor, :8398-8522). Written from
// the spec in the Python modules (entropy/palette.py, encoder/palette_codec.py,
// encoder/dyn1d.py); those remain the readable reference and the fallback.
//
// Build: tools/build_native.sh -> yaik_tpu/native/libyaik_host.so
// ABI: plain C, used via ctypes.
#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------------------
// Palette decompressor. Returns decompressed byte count or -1 on error.
// ---------------------------------------------------------------------------
int palette_decompress(const uint8_t* input, int input_size,
                       uint8_t* output, int output_size,
                       int color_compression) {
    if (input_size < 1) return -1;
    int pos = 0;
    int cb_size = input[pos++];
    // codebook aliases the input stream in place (indices may exceed
    // cb_size and read the following stream bytes; zero beyond the end)
    const uint8_t* codebook = input + 1;
    int cb_avail = input_size - 1;
    pos += cb_size * 3;
    if (pos + 3 > input_size) return -1;
    output[0] = input[pos++];
    output[1] = input[pos++];
    output[2] = input[pos++];
    int last = 0;
    int write = 3;

    auto cb = [&](int i) -> uint8_t {
        return (i < cb_avail) ? codebook[i] : 0;
    };

    while (write <= output_size - 3) {
        if (pos >= input_size) return -1;
        int c = input[pos++];
        if (c & 0x80) {
            if (c & 0x40) {
                last = write - ((c & 0x3F) + 2) * 3;
                if (last < 0) return -1;
            } else {
                int sub = (c >> 3) & 7;
                if (sub == 0) {
                    for (int i = 0; i < 3; i++) {
                        int d = 0;
                        if (c & (1 << i)) {
                            if (pos >= input_size) return -1;
                            d = input[pos++];
                        }
                        output[write + i] = (uint8_t)(output[last + i] + d);
                    }
                } else if (sub == 1) {
                    for (int i = 0; i < 3; i++) {
                        if (c & (1 << i)) {
                            if (pos >= input_size) return -1;
                            output[write + i] = input[pos++];
                        } else {
                            output[write + i] = output[last + i];
                        }
                    }
                } else {
                    return -1;
                }
                last = write;
                write += 3;
            }
        } else {
            int k = (c & 0x7F) * 3;
            output[write]     = (uint8_t)(output[last]     + cb(k));
            output[write + 1] = (uint8_t)(output[last + 1] + cb(k + 1));
            output[write + 2] = (uint8_t)(output[last + 2] + cb(k + 2));
            last = write;
            write += 3;
        }
    }
    // full-range remap v -> (v * ((255<<16)/range)) >> 16
    int inv = color_compression ? ((255 << 16) / color_compression)
                                : (255 << 16);
    for (int i = 0; i < output_size; i++) {
        output[i] = (uint8_t)(((int)output[i] * inv) >> 16);
    }
    return output_size;
}

// ---------------------------------------------------------------------------
// Palette compressor with persistent codebook state (the reference's global
// CodeRGB). `state` is caller-owned: entries[slot*3..] deltas as int32,
// state_len = number of valid slots (grows monotonically).
// Returns compressed size or -1 on output overflow.
// ---------------------------------------------------------------------------
struct CodeEntry { int32_t ref; int32_t dr, dg, db; };

// Open-addressing map from an RGB delta triple (each in [-255,255], 27-bit
// key) to the smallest index that holds it. Replaces the linear scans in
// palette_compress (the book dedup was O(count*n) and find_code scanned 64
// slots per pixel - together the encoder's hottest host loops).
struct DeltaMap {
    int32_t* keys;
    int32_t* vals;
    uint32_t mask;
    void init(uint32_t cap_pow2) {
        mask = cap_pow2 - 1;
        keys = (int32_t*)malloc(sizeof(int32_t) * cap_pow2);
        vals = (int32_t*)malloc(sizeof(int32_t) * cap_pow2);
        memset(keys, 0xFF, sizeof(int32_t) * cap_pow2);   // -1 = empty
    }
    void fini() { free(keys); free(vals); }
    static inline int32_t key_of(int dr, int dg, int db) {
        return (dr + 255) | ((dg + 255) << 9) | ((db + 255) << 18);
    }
    // insert idx if the key is absent (first insert wins); returns the
    // index already stored, or -1 when this call inserted / ins < 0
    inline int32_t find_or_insert(int32_t key, int32_t ins) {
        uint32_t hsh = ((uint32_t)key * 2654435761u) & mask;
        for (;;) {
            int32_t k = keys[hsh];
            if (k == key) return vals[hsh];
            if (k == -1) {
                if (ins >= 0) { keys[hsh] = key; vals[hsh] = ins; }
                return -1;
            }
            hsh = (hsh + 1) & mask;
        }
    }
};

static inline uint32_t pow2_at_least(uint32_t v) {
    uint32_t p = 64;
    while (p < v) p <<= 1;
    return p;
}

static int cmp_ref_desc_stable(const void* a, const void* b) {
    const CodeEntry* f = (const CodeEntry*)a;
    const CodeEntry* s = (const CodeEntry*)b;
    if (f->ref < s->ref) return 1;
    if (f->ref > s->ref) return -1;
    return 0;
}

int palette_compress(const uint8_t* input, int size,
                     uint8_t* output, int max_out,
                     int32_t* state, int32_t* state_len) {
    int n = size / 3;
    if (n < 1) return -1;

    DeltaMap smap;   // find_code table, filled after phase 1 (EMIT frees it)
    smap.init(256);
    // phase 1: build codebook (book entries are unique by construction, so
    // a first-insert-wins map IS the "break on first match" linear scan)
    CodeEntry* book = (CodeEntry*)malloc(sizeof(CodeEntry) * (size_t)(n + 1));
    DeltaMap bmap;
    bmap.init(pow2_at_least((uint32_t)(2 * n + 64)));
    int count = 0;
    book[count++] = {0, 0, 0, 0};
    bmap.find_or_insert(DeltaMap::key_of(0, 0, 0), 0);
    for (int i = 1; i < n; i++) {
        int lo = i - 64; if (lo < 0) lo = 0;
        long best = 0x7FFFFFFFFFFFL;
        int br = 0, bg = 0, bb = 0;
        const uint8_t* pix = input + i * 3;
        for (int p = lo; p < i; p++) {
            int dr = pix[0] - input[p * 3];
            int dg = pix[1] - input[p * 3 + 1];
            int db = pix[2] - input[p * 3 + 2];
            long dist = (long)dr * dr + (long)dg * dg + (long)db * db;
            if (dist < best) { best = dist; br = dr; bg = dg; bb = db; }
        }
        int found = bmap.find_or_insert(DeltaMap::key_of(br, bg, bb), count);
        if (found >= 0) book[found].ref++;
        else book[count++] = {0, br, bg, bb};
    }
    bmap.fini();
    // stable descending by refcount (entry 0 pinned); glibc qsort is
    // mergesort-based here, but use an explicitly stable comparator path:
    // qsort with ref-desc plus original-index tiebreak
    for (int k = 0; k < count; k++) book[k].ref = book[k].ref * 65536 + (65535 - (k & 0xFFFF));
    qsort(book + 1, (size_t)(count - 1), sizeof(CodeEntry),
          cmp_ref_desc_stable);
    for (int k = 0; k < count; k++) book[k].ref /= 65536;

    int final_count = count > 128 ? 128 : count;
    // persist into state (overwrite first `count` slots)
    for (int k = 0; k < count && k < 4096; k++) {
        state[k * 3] = book[k].dr;
        state[k * 3 + 1] = book[k].dg;
        state[k * 3 + 2] = book[k].db;
    }
    if (count > *state_len) *state_len = count < 4096 ? count : 4096;

    int out = 0;
    #define EMIT(v) do { if (out >= max_out) { smap.fini(); free(book); \
                         return -1; } \
                         output[out++] = (uint8_t)(v); } while (0)
    EMIT(final_count);
    for (int k = 0; k < final_count; k++) {
        EMIT(book[k].dr); EMIT(book[k].dg); EMIT(book[k].db);
    }
    EMIT(input[0]); EMIT(input[1]); EMIT(input[2]);

    // search table = persistent slots 0..63 (stale tail included). state is
    // fixed for the rest of this call, so one 64-entry map (smallest slot
    // wins duplicate deltas = the linear scan's first match) makes
    // find_code O(1); deltas outside [-255,255] can't be in the table.
    for (int k = 63; k >= 0; k--) {
        int dr = state[k * 3], dg = state[k * 3 + 1], db = state[k * 3 + 2];
        if (dr < -255 || dr > 255 || dg < -255 || dg > 255 ||
            db < -255 || db > 255)
            continue;
        // rebuild-insert: later (smaller k) overwrite via fresh probe
        int32_t key = DeltaMap::key_of(dr, dg, db);
        uint32_t hsh = ((uint32_t)key * 2654435761u) & smap.mask;
        for (;;) {
            if (smap.keys[hsh] == key) { smap.vals[hsh] = k; break; }
            if (smap.keys[hsh] == -1) {
                smap.keys[hsh] = key; smap.vals[hsh] = k; break;
            }
            hsh = (hsh + 1) & smap.mask;
        }
    }
    auto find_code = [&](int dr, int dg, int db) -> int {
        return smap.find_or_insert(DeltaMap::key_of(dr, dg, db), -1);
    };

    for (int i = 1; i < n; i++) {
        const uint8_t* pix = input + i * 3;
        int dr = pix[0] - input[(i - 1) * 3];
        int dg = pix[1] - input[(i - 1) * 3 + 1];
        int db = pix[2] - input[(i - 1) * 3 + 2];
        int k = find_code(dr, dg, db);
        if (k >= 0) { EMIT(k & 0x7F); continue; }

        int lo = i - 65; if (lo < 0) lo = 0;
        int best_idx = 999, best_dist = 0;
        for (int p = i - 2; p >= lo; p--) {
            int pr = pix[0] - input[p * 3];
            int pg = pix[1] - input[p * 3 + 1];
            int pb = pix[2] - input[p * 3 + 2];
            int kk = find_code(pr, pg, pb);
            if (kk >= 0) {
                int distance = (i - p) - 2;
                if (distance < 64 && kk < best_idx) {
                    best_idx = kk; best_dist = distance;
                    if (best_idx == 0) break;   // nothing can beat slot 0
                }
            }
        }
        if (best_idx != 999) {
            EMIT(0xC0 | (best_dist & 0x3F));
            EMIT(best_idx & 0x7F);
            continue;
        }
        int mask = (dr ? 1 : 0) | (dg ? 2 : 0) | (db ? 4 : 0);
        if (dr >= -128 && dr <= 127 && dg >= -128 && dg <= 127 &&
            db >= -128 && db <= 127) {
            EMIT(0x80 | mask);
            if (dr) EMIT(dr);
            if (dg) EMIT(dg);
            if (db) EMIT(db);
        } else {
            EMIT(0x88 | mask);
            if (dr) EMIT(pix[0]);
            if (dg) EMIT(pix[1]);
            if (db) EMIT(pix[2]);
        }
    }
    #undef EMIT
    smap.fini();
    free(book);
    return out;
}

// ---------------------------------------------------------------------------
// 1D residual pass for one plane (DynamicTileCompressor semantics).
// plane: [h][w] u8; claim: [h][w] u8 (nonzero = claimed).
// pix_out / type_out are caller buffers; returns pixel stream length,
// writes type stream length to *type_len.
// ---------------------------------------------------------------------------
int dyn1d_plane(const uint8_t* plane, const uint8_t* claim, int w, int h,
                int color_compression, int range_compression,
                uint8_t* pix_out, uint8_t* type_out, int* type_len) {
    int pcur = 0, tcur = 0;
    int inv_range = (1 << 24) / range_compression;  // parity w/ decoder
    (void)inv_range;
    for (int y = 0; y < h; y += 8) {
        for (int x = 0; x < w; x += 8) {
            uint8_t vals[64];
            int histo[256];
            memset(histo, 0, sizeof(histo));
            int cnt = 0;
            for (int y2 = 0; y2 < 8; y2 += 4) {
                bool has_left = claim[(y + y2) * w + x] == 0;
                bool has_right = claim[(y + y2) * w + x + 4] == 0;
                if (!(has_left || has_right)) continue;
                int x2 = 0, length = 4;
                if (has_left && has_right) { length = 8; }
                else if (has_right) { x2 = 4; }
                for (int iy = 0; iy < 4; iy++) {
                    for (int ix = 0; ix < length; ix++) {
                        int v = plane[(y + y2 + iy) * w + x + x2 + ix];
                        v = ((v * color_compression) + 127) / 255;
                        histo[v]++;
                        vals[cnt++] = (uint8_t)v;
                    }
                }
            }
            if (cnt == 0) continue;
            // most-used: ties to the RIGHT
            int best = -1, color0 = -1;
            for (int v = 0; v < 256; v++) {
                if (histo[v] >= best) { best = histo[v]; color0 = v; }
            }
            if (color0 == 0) color0 = 1;
            if (color0 == 255) color0 = 254;
            histo[color0 - 1] = histo[color0] = histo[color0 + 1] = 0;
            int mn = 99999, mx = -99999;
            for (int v = 0; v < 256; v++) {
                if (histo[v]) { if (v < mn) mn = v; if (v > mx) mx = v; }
            }
            int min_col = 0, delta = 0;
            if (mn != 99999) { min_col = mn; delta = mx - mn; }
            for (int i = 0; i < cnt; i++) {
                int v = vals[i];
                if (v >= color0 - 1 && v <= color0 + 1) {
                    pix_out[pcur++] = 0;
                } else {
                    int idx = 0;
                    if (delta) {
                        // C truncating division (numerator can be -1)
                        idx = ((v - min_col) * range_compression
                               + (delta >> 1) - 1) / delta;
                    }
                    pix_out[pcur++] = (uint8_t)(1 + idx);
                }
            }
            type_out[tcur++] = (uint8_t)color0;
            type_out[tcur++] = (uint8_t)min_col;
            type_out[tcur++] = (uint8_t)delta;
        }
    }
    *type_len = tcur;
    return pcur;
}


// ---------------------------------------------------------------------------
// Decode-planner replay: the per-tile sequential stages of building a dense
// DecodePlan (decoder/planner.py is the readable reference). Mirrors the
// reference's tile-by-tile stream walk (YAIK_API.cpp:1248-1420) but writes
// dense per-tile tensors for the device engine instead of pixels.
// ---------------------------------------------------------------------------

// GTIL corner-stream first-touch dedup: ids[4n] corner grid indices in read
// order (LT,RT,LB,RB per accepted tile); consumes 3 bytes of rgb3 per
// first touch. rgb3 must be padded by the caller (security offset).
void plan_gtil_corners(int64_t n4, const int64_t* ids, const uint8_t* rgb3,
                       uint8_t* map_rgb, uint8_t* has_rgb) {
    int64_t k = 0;
    for (int64_t j = 0; j < n4; ++j) {
        int64_t id = ids[j];
        if (!has_rgb[id]) {
            has_rgb[id] = 1;
            map_rgb[3 * id] = rgb3[3 * k];
            map_rgb[3 * id + 1] = rgb3[3 * k + 1];
            map_rgb[3 * id + 2] = rgb3[3 * k + 2];
            ++k;
        }
    }
}

// Quad-pair groups per 3D pass (quad coords inside the tile; gx1 = -1 marks
// a single-quad group). Pass ids follow TILE3D_PASS_ORDER:
//   0:(4,3) 1:(3,4) 2:(3,3) 3:(3,2) 4:(2,3) 5:(2,2)
struct PassGroup { int gx0, gy0, gx1; };
static const PassGroup kGroups43[] = {{0,0,1},{0,1,1},{2,0,3},{2,1,3}};
static const PassGroup kGroups34[] = {{0,0,1},{0,1,1},{0,2,1},{0,3,1}};
static const PassGroup kGroups33[] = {{0,0,1},{0,1,1}};
static const PassGroup kGroups32[] = {{0,0,1}};
static const PassGroup kGroups23[] = {{0,0,-1},{0,1,-1}};
static const PassGroup kGroups22[] = {{0,0,-1}};
static const PassGroup* kPassGroups[6] = {kGroups43, kGroups34, kGroups33,
                                          kGroups32, kGroups23, kGroups22};
static const int kPassGroupCnt[6] = {4, 4, 2, 1, 2, 1};
static const int kPassTw[6] = {16, 8, 8, 8, 4, 4};
static const int kPassTqw[6] = {4, 2, 2, 2, 1, 1};
static const int kPassTqh[6] = {2, 4, 2, 1, 2, 1};

static inline void copy_quad(const uint8_t* src, int64_t slen, int64_t& cur,
                             uint8_t* idx, uint8_t* wm, int64_t base, int gx,
                             int gy, int tw, int premult) {
    if (cur + 16 <= slen) {
        // fast path: bounds hoisted out of the loop so rows copy/divide
        // without per-byte branches (planning is the decode host wall)
        const uint8_t* s = src + cur;
        for (int y = 0; y < 4; ++y) {
            uint8_t* d = idx + base + (int64_t)(y + gy * 4) * tw + gx * 4;
            uint8_t* m = wm + base + (int64_t)(y + gy * 4) * tw + gx * 4;
            if (premult)
                for (int x = 0; x < 4; ++x) d[x] = (uint8_t)(s[x] / 3);
            else
                memcpy(d, s, 4);
            memset(m, 1, 4);
            s += 4;
        }
        cur += 16;
        return;
    }
    for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) {
            int64_t slot = base + (int64_t)(y + gy * 4) * tw + x + gx * 4;
            // corrupt streams read zeros past the end (security offset)
            uint8_t v = cur < slen ? src[cur] : 0;
            ++cur;
            idx[slot] = premult ? (uint8_t)(v / 3) : v;
            wm[slot] = 1;
        }
}

// One 3D size pass (or one 1D plane with pass_id 1 semantics, see caller):
// replays the claim-gated quad-pair stream walk for n accepted tiles in scan
// order. streams must be padded by the caller. Returns bytes consumed.
int64_t plan_pass_scatter(int64_t n, const int32_t* gid, const int32_t* qx0,
                          const int32_t* qy0, int pass_id,
                          uint8_t* claims, int64_t qw_stride,
                          const uint8_t* stream, int64_t slen, int64_t cur,
                          uint8_t* indices, uint8_t* wmask, int P,
                          int premult, int update_claims) {
    const PassGroup* groups = kPassGroups[pass_id];
    const int ng = kPassGroupCnt[pass_id];
    const int tw = kPassTw[pass_id];
    const int tqw = kPassTqw[pass_id], tqh = kPassTqh[pass_id];
    const int64_t start = cur;
    for (int64_t i = 0; i < n; ++i) {
        const int64_t base = (int64_t)gid[i] * P;
        const int64_t q0 = (int64_t)qy0[i] * qw_stride + qx0[i];
        for (int g = 0; g < ng; ++g) {
            const PassGroup& gr = groups[g];
            const int64_t qa = q0 + (int64_t)gr.gy0 * qw_stride + gr.gx0;
            if (gr.gx1 < 0) {                 // single quad
                if (!claims[qa])
                    copy_quad(stream, slen, cur, indices, wmask, base,
                              gr.gx0, gr.gy0, tw, premult);
                continue;
            }
            const bool b0 = claims[qa];
            const bool b1 = claims[q0 + (int64_t)gr.gy0 * qw_stride + gr.gx1];
            if (!b0 && !b1) {                 // full 4x8 pair
                for (int y = 0; y < 4; ++y)
                    for (int x = 0; x < 8; ++x) {
                        int64_t slot = base + (int64_t)(y + gr.gy0 * 4) * tw
                                       + x + gr.gx0 * 4;
                        uint8_t v = cur < slen ? stream[cur] : 0;
                        ++cur;
                        indices[slot] = premult ? (uint8_t)(v / 3) : v;
                        wmask[slot] = 1;
                    }
            } else if (!b0) {
                copy_quad(stream, slen, cur, indices, wmask, base,
                          gr.gx0, gr.gy0, tw, premult);
            } else if (!b1) {
                copy_quad(stream, slen, cur, indices, wmask, base,
                          gr.gx0 + 1, gr.gy0, tw, premult);
            }
        }
        if (update_claims)
            for (int qy = 0; qy < tqh; ++qy)
                for (int qx = 0; qx < tqw; ++qx)
                    claims[q0 + (int64_t)qy * qw_stride + qx] = 1;
    }
    return cur - start;
}

// One 3D size pass over ALL accepted tiles in scan order, each consuming
// from the stream of its own bit depth (types>>14). Cursors[4] in/out.
void plan_pass_scatter4(int64_t n, const int32_t* gid, const int32_t* qx0,
                        const int32_t* qy0, const uint8_t* bits,
                        int pass_id, uint8_t* claims, int64_t qw_stride,
                        const uint8_t* s3, int64_t l3,
                        const uint8_t* s4, int64_t l4,
                        const uint8_t* s5, int64_t l5,
                        const uint8_t* s6, int64_t l6,
                        int64_t* cursors, uint8_t* indices, uint8_t* wmask,
                        int P) {
    const uint8_t* streams[4] = {s3, s4, s5, s6};
    const int64_t lens[4] = {l3, l4, l5, l6};
    const PassGroup* groups = kPassGroups[pass_id];
    const int ng = kPassGroupCnt[pass_id];
    const int tw = kPassTw[pass_id];
    const int tqw = kPassTqw[pass_id], tqh = kPassTqh[pass_id];
    for (int64_t i = 0; i < n; ++i) {
        const int b = bits[i] - 3;
        const uint8_t* stream = streams[b];
        const int64_t slen = lens[b];
        int64_t cur = cursors[b];
        const int64_t base = (int64_t)gid[i] * P;
        const int64_t q0 = (int64_t)qy0[i] * qw_stride + qx0[i];
        for (int g = 0; g < ng; ++g) {
            const PassGroup& gr = groups[g];
            const int64_t qa = q0 + (int64_t)gr.gy0 * qw_stride + gr.gx0;
            if (gr.gx1 < 0) {
                if (!claims[qa])
                    copy_quad(stream, slen, cur, indices, wmask, base,
                              gr.gx0, gr.gy0, tw, 1);
                continue;
            }
            const bool b0 = claims[qa];
            const bool b1 = claims[q0 + (int64_t)gr.gy0 * qw_stride + gr.gx1];
            if (!b0 && !b1) {
                for (int y = 0; y < 4; ++y)
                    for (int x = 0; x < 8; ++x) {
                        int64_t slot = base + (int64_t)(y + gr.gy0 * 4) * tw
                                       + x + gr.gx0 * 4;
                        uint8_t v = cur < slen ? stream[cur] : 0;
                        ++cur;
                        indices[slot] = (uint8_t)(v / 3);
                        wmask[slot] = 1;
                    }
            } else if (!b0) {
                copy_quad(stream, slen, cur, indices, wmask, base,
                          gr.gx0, gr.gy0, tw, 1);
            } else if (!b1) {
                copy_quad(stream, slen, cur, indices, wmask, base,
                          gr.gx0 + 1, gr.gy0, tw, 1);
            }
        }
        cursors[b] = cur;
        for (int qy = 0; qy < tqh; ++qy)
            for (int qx = 0; qx < tqw; ++qx)
                claims[q0 + (int64_t)qy * qw_stride + qx] = 1;
    }
}

// ---------------------------------------------------------------------------
// Consolidated single-call pass planners: walk the swizzled accept bitmap in
// stream order (big tiles row-major, LSB-first bits - format/swizzle.py) and
// do the gather + claim-gated scatter inline. One ctypes call per pass
// replaces the unpackbits / flatnonzero / fancy-index glue that dominated
// planning time (VERDICT r1 #4: host planning is the decode bottleneck).
// ---------------------------------------------------------------------------

// Swizzle spec per 3D pass id (TILE3D_PASS_ORDER) + shifts.
static const int kPassSx[6] = {4, 3, 3, 3, 2, 2};
static const int kPassSy[6] = {3, 4, 3, 2, 3, 2};
static const int kPassBx[6] = {64, 64, 64, 64, 32, 32};
static const int kPassBy[6] = {64, 64, 64, 32, 64, 32};

// 3D index byte -> packed device form: min(v/3, 63) | written<<6 (the
// device kernels consume idx = packed & 63, wmask = packed >> 6; corrupt
// streams can carry v/3 up to 85, clamp keeps the index in 6 bits).
// Table form: one load replaces divide+clamp+or per byte.
static const struct Pack3Table {
    uint8_t t[256];
    Pack3Table() {
        for (int v = 0; v < 256; ++v) {
            int q = v / 3;
            t[v] = (uint8_t)((q > 63 ? 63 : q) | 0x40);
        }
    }
} kPack3;

static inline void pack_quad(const uint8_t* src, int64_t slen, int64_t& cur,
                             uint8_t* packed, int64_t base, int gx, int gy,
                             int tw) {
    if (cur + 16 <= slen) {
        const uint8_t* s = src + cur;
        for (int y = 0; y < 4; ++y) {
            uint8_t* d = packed + base + (int64_t)(y + gy * 4) * tw + gx * 4;
            d[0] = kPack3.t[s[0]]; d[1] = kPack3.t[s[1]];
            d[2] = kPack3.t[s[2]]; d[3] = kPack3.t[s[3]];
            s += 4;
        }
        cur += 16;
        return;
    }
    for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) {
            int64_t slot = base + (int64_t)(y + gy * 4) * tw + x + gx * 4;
            uint8_t v = cur < slen ? src[cur] : 0;
            ++cur;
            packed[slot] = kPack3.t[v];
        }
}

// One full 3D size pass from the raw uncompressed bitmap. Writes accept
// [nty*ntx] u8, type_arr [g] i32, cols [g,6] i32 and packed [g,P] u8
// (idx|wmask<<6, caller-zeroed), updates claims + the 4 stream cursors.
// Returns the number of accepted tiles (type/color cursor advance). All
// stream reads are bound-checked (zeros past the end).
int64_t plan_3d_pass_full(const uint8_t* bitmap, int64_t bitmap_len,
                          int w, int h, int pass_id,
                          const uint16_t* types, int64_t types_len,
                          const int32_t* colors, int64_t colors_len,
                          int64_t tcur,
                          uint8_t* claims, int64_t qw_stride,
                          const uint8_t* s3, int64_t l3,
                          const uint8_t* s4, int64_t l4,
                          const uint8_t* s5, int64_t l5,
                          const uint8_t* s6, int64_t l6,
                          int64_t* cursors,
                          uint8_t* accept, int32_t* type_arr, int32_t* cols,
                          uint8_t* packed, int P) {
    const int sx = kPassSx[pass_id], sy = kPassSy[pass_id];
    const int bx = kPassBx[pass_id], by = kPassBy[pass_id];
    const int tw = 1 << sx, th = 1 << sy;
    const int ntx = w >> sx, nty = h >> sy;
    const int nbx = (w + bx - 1) / bx, nby = (h + by - 1) / by;
    const int colsw = bx >> sx, rowsw = by >> sy;
    const int bits_per_word = colsw * rowsw;
    const int64_t total_bits = (int64_t)nbx * nby * bits_per_word;

    const uint8_t* streams[4] = {s3, s4, s5, s6};
    const int64_t lens[4] = {l3, l4, l5, l6};
    const PassGroup* groups = kPassGroups[pass_id];
    const int ng = kPassGroupCnt[pass_id];
    const int tqw = kPassTqw[pass_id], tqh = kPassTqh[pass_id];

    int64_t n_acc = 0;
    // 64-bit word scan + ctz: dense photo-content bitmaps made the per-bit
    // walk the planning hot spot (bits are LSB-first within bytes and
    // byte-ascending, so a little-endian u64 iterates k ascending)
    const int64_t nbytes_avail =
        bitmap_len < (total_bits + 7) / 8 ? bitmap_len : (total_bits + 7) / 8;
    for (int64_t byte = 0; byte < nbytes_avail; ) {
        uint64_t wd = 0;
        const int nb = (int)(nbytes_avail - byte < 8 ? nbytes_avail - byte
                                                     : 8);
        memcpy(&wd, bitmap + byte, nb);
        while (wd) {
        const int64_t k = byte * 8 + __builtin_ctzll(wd);
        wd &= wd - 1;
        if (k >= total_bits) break;
        const int64_t big = k / bits_per_word;
        const int within = (int)(k % bits_per_word);
        const int tx = (int)(big % nbx) * colsw + within % colsw;
        const int ty = (int)(big / nbx) * rowsw + within / colsw;
        if ((int64_t)tx * tw >= w || (int64_t)ty * th >= h) continue;
        if (tx >= ntx || ty >= nty) continue;   // partial edge tile
        const int64_t tid = tcur + n_acc;
        ++n_acc;
        const uint16_t tt = tid < types_len ? types[tid] : 0;
        const int b = (tt >> 14) & 3;
        const int64_t gid = (int64_t)ty * ntx + tx;
        accept[gid] = 1;
        type_arr[gid] = tt;
        if (tid < colors_len)
            for (int c = 0; c < 6; ++c)
                cols[gid * 6 + c] = colors[tid * 6 + c];

        const uint8_t* stream = streams[b];
        const int64_t slen = lens[b];
        int64_t cur = cursors[b];
        const int64_t base = gid * P;
        const int qx0 = tx * tqw, qy0 = ty * tqh;
        const int64_t q0 = (int64_t)qy0 * qw_stride + qx0;
        for (int g = 0; g < ng; ++g) {
            const PassGroup& gr = groups[g];
            const int64_t qa = q0 + (int64_t)gr.gy0 * qw_stride + gr.gx0;
            if (gr.gx1 < 0) {
                if (!claims[qa])
                    pack_quad(stream, slen, cur, packed, base,
                              gr.gx0, gr.gy0, tw);
                continue;
            }
            const bool b0 = claims[qa];
            const bool b1 = claims[q0 + (int64_t)gr.gy0 * qw_stride + gr.gx1];
            if (!b0 && !b1) {
                if (cur + 32 <= slen) {
                    const uint8_t* s = stream + cur;
                    for (int y = 0; y < 4; ++y) {
                        uint8_t* d = packed + base
                                     + (int64_t)(y + gr.gy0 * 4) * tw
                                     + gr.gx0 * 4;
                        for (int x = 0; x < 8; ++x) d[x] = kPack3.t[s[x]];
                        s += 8;
                    }
                    cur += 32;
                } else {
                    for (int y = 0; y < 4; ++y)
                        for (int x = 0; x < 8; ++x) {
                            int64_t slot = base
                                           + (int64_t)(y + gr.gy0 * 4) * tw
                                           + x + gr.gx0 * 4;
                            uint8_t v = cur < slen ? stream[cur] : 0;
                            ++cur;
                            packed[slot] = kPack3.t[v];
                        }
                }
            } else if (!b0) {
                pack_quad(stream, slen, cur, packed, base,
                          gr.gx0, gr.gy0, tw);
            } else if (!b1) {
                pack_quad(stream, slen, cur, packed, base,
                          gr.gx0 + 1, gr.gy0, tw);
            }
        }
        cursors[b] = cur;
        for (int qy = 0; qy < tqh; ++qy)
            for (int qx = 0; qx < tqw; ++qx)
                claims[q0 + (int64_t)qy * qw_stride + qx] = 1;
        }
        byte += nb;
    }
    return n_acc;
}

// All six 3D size passes in ONE call: per-pass bitmap pointers/lengths in
// [6]-arrays, outputs written into the caller's contiguous arenas at the
// canonical per-pass offsets (TILE3D_PASS_ORDER). Replaces six ctypes
// crossings + ~78 pointer resolutions per image in the planning hot path.
void plan_3d_all(const int64_t* bm_ptrs, const int64_t* bm_lens,
                 int w, int h,
                 const uint16_t* types, int64_t types_len,
                 const int32_t* colors, int64_t colors_len,
                 uint8_t* claims, int64_t qw_stride,
                 const uint8_t* s3, int64_t l3,
                 const uint8_t* s4, int64_t l4,
                 const uint8_t* s5, int64_t l5,
                 const uint8_t* s6, int64_t l6,
                 int64_t* cursors,
                 uint8_t* accept_all, int32_t* type_all, int32_t* cols_all,
                 uint8_t* packed_all) {
    int64_t tcur = 0, goff = 0, poff = 0;
    for (int p = 0; p < 6; ++p) {
        const int tw = 1 << kPassSx[p], th = 1 << kPassSy[p];
        const int64_t g = (int64_t)(w >> kPassSx[p]) * (h >> kPassSy[p]);
        if (bm_lens[p])
            tcur += plan_3d_pass_full(
                (const uint8_t*)(uintptr_t)bm_ptrs[p], bm_lens[p], w, h, p,
                types, types_len, colors, colors_len, tcur,
                claims, qw_stride, s3, l3, s4, l4, s5, l5, s6, l6,
                cursors, accept_all + goff, type_all + goff,
                cols_all + goff * 6, packed_all + poff, tw * th);
        goff += g;
        poff += g * tw * th;
    }
}

// One full GTIL pass (plane == 7): scan-order walk of the bitmap, corner
// first-touch dedup consuming rgb3 (caller-padded), quad claims (clipped at
// the claim-grid edge), accept grid out ([nty,ntx] u8, ceil dims).
void plan_gtil_full(const uint8_t* bitmap, int64_t bitmap_len,
                    int w, int h, int sx, int sy, int bx, int by,
                    const uint8_t* rgb3, int64_t rgb3_len,
                    uint8_t* map_rgb, uint8_t* has_rgb, int64_t stride_q,
                    uint8_t* claims, int64_t qh, int64_t qw_stride,
                    uint8_t* accept) {
    const int tw = 1 << sx, th = 1 << sy;
    const int ntx = (w + tw - 1) / tw;
    const int nbx = (w + bx - 1) / bx, nby = (h + by - 1) / by;
    const int colsw = bx >> sx, rowsw = by >> sy;
    const int bits_per_word = colsw * rowsw;
    const int64_t total_bits = (int64_t)nbx * nby * bits_per_word;
    const int tqw = tw / 4, tqh = th / 4;

    int64_t rcur = 0;   // rgb3 pixel cursor (units of 3 bytes)
    const int64_t nbytes_avail =
        bitmap_len < (total_bits + 7) / 8 ? bitmap_len : (total_bits + 7) / 8;
    for (int64_t byte = 0; byte < nbytes_avail; ) {
        uint64_t wd = 0;
        const int nb = (int)(nbytes_avail - byte < 8 ? nbytes_avail - byte
                                                     : 8);
        memcpy(&wd, bitmap + byte, nb);
        while (wd) {
        const int64_t k = byte * 8 + __builtin_ctzll(wd);
        wd &= wd - 1;
        if (k >= total_bits) break;
        const int64_t big = k / bits_per_word;
        const int within = (int)(k % bits_per_word);
        const int tx = (int)(big % nbx) * colsw + within % colsw;
        const int ty = (int)(big / nbx) * rowsw + within / colsw;
        if ((int64_t)tx * tw >= w || (int64_t)ty * th >= h) continue;
        accept[(int64_t)ty * ntx + tx] = 1;
        const int qx0 = tx * tqw, qy0 = ty * tqh;
        const int64_t base = (int64_t)qy0 * stride_q + qx0;
        const int64_t ids[4] = {base, base + tqw,
                                base + (int64_t)tqh * stride_q,
                                base + (int64_t)tqh * stride_q + tqw};
        for (int c = 0; c < 4; ++c) {
            const int64_t id = ids[c];
            if (!has_rgb[id]) {
                has_rgb[id] = 1;
                for (int j = 0; j < 3; ++j)
                    map_rgb[3 * id + j] =
                        3 * rcur + j < rgb3_len ? rgb3[3 * rcur + j] : 0;
                ++rcur;
            }
        }
        for (int qy = 0; qy < tqh; ++qy)
            for (int qx = 0; qx < tqw; ++qx) {
                const int64_t y = qy0 + qy, x = qx0 + qx;
                if (y < qh && x < qw_stride)
                    claims[y * qw_stride + x] = 1;
            }
        }
        byte += nb;
    }
}

// One full 1D residual plane (pass_id 2 group walk over active 8x8 tiles):
// active detection from the claim grid, type-triplet gather + param
// computation, claim-gated pixel scatter. Returns n_active; advances
// *tcur_io (bytes) and *pcur_io.
void plan_1d_plane_full(int w, int h, const uint8_t* claims,
                        int64_t qw_stride,
                        const uint8_t* types, int64_t types_len,
                        const uint8_t* pix, int64_t pix_len,
                        int64_t inv_range,
                        int64_t* tcur_io, int64_t* pcur_io,
                        int32_t* params, uint8_t* indices, uint8_t* wmask) {
    const int ntx = w / 8, nty = h / 8;
    int64_t tcur = *tcur_io, pcur = *pcur_io;
    for (int ty = 0; ty < nty; ++ty)
        for (int tx = 0; tx < ntx; ++tx) {
            const int64_t q0 = (int64_t)ty * 2 * qw_stride + tx * 2;
            if (claims[q0] && claims[q0 + 1] &&
                claims[q0 + qw_stride] && claims[q0 + qw_stride + 1])
                continue;
            const int64_t gid = (int64_t)ty * ntx + tx;
            const int64_t c0 = tcur < types_len ? types[tcur] : 0;
            const int64_t bs = tcur + 1 < types_len ? types[tcur + 1] : 0;
            const int64_t dl = tcur + 2 < types_len ? types[tcur + 2] : 0;
            tcur += 3;
            params[gid * 3] = (int32_t)c0;
            params[gid * 3 + 1] = (int32_t)bs;
            params[gid * 3 + 2] = (int32_t)(((dl * inv_range) >> 8) + 1);
            // two 4x8 pair groups of the 8x8 tile (claims NOT updated)
            for (int g = 0; g < 2; ++g) {
                const int64_t qa = q0 + (int64_t)g * qw_stride;
                const bool b0 = claims[qa];
                const bool b1 = claims[qa + 1];
                const int64_t base = gid * 64;
                if (!b0 && !b1) {
                    // 4x8 rows are contiguous in the 8-wide tile: one
                    // 32-byte copy + mask fill
                    if (pcur + 32 <= pix_len) {
                        memcpy(indices + base + g * 32, pix + pcur, 32);
                        memset(wmask + base + g * 32, 1, 32);
                        pcur += 32;
                    } else {
                        for (int y = 0; y < 4; ++y)
                            for (int x = 0; x < 8; ++x) {
                                int64_t slot = base
                                               + (int64_t)(y + g * 4) * 8 + x;
                                uint8_t v = pcur < pix_len ? pix[pcur] : 0;
                                ++pcur;
                                indices[slot] = v;
                                wmask[slot] = 1;
                            }
                    }
                } else if (!b0) {
                    copy_quad(pix, pix_len, pcur, indices, wmask, base,
                              0, g, 8, 0);
                } else if (!b1) {
                    copy_quad(pix, pix_len, pcur, indices, wmask, base,
                              1, g, 8, 0);
                }
            }
        }
    *tcur_io = tcur;
    *pcur_io = pcur;
}

// All three 1D residual planes in one call (shared type/pixel cursors;
// claims either shared [QH,QW] or per-plane [3,QH,QW] via plane_stride).
void plan_1d_all(int w, int h, const uint8_t* claims, int64_t plane_stride,
                 int64_t qw_stride, const uint8_t* types, int64_t types_len,
                 const uint8_t* pix, int64_t pix_len, int64_t inv_range,
                 int32_t* params, uint8_t* indices, uint8_t* wmask) {
    int64_t tcur = 0, pcur = 0;
    const int64_t g = (int64_t)(w / 8) * (h / 8);
    for (int p = 0; p < 3; ++p)
        plan_1d_plane_full(w, h, claims + p * plane_stride, qw_stride,
                           types, types_len, pix, pix_len, inv_range,
                           &tcur, &pcur, params + p * g * 3,
                           indices + p * g * 64, wmask + p * g * 64);
}

// Encoder GTIL emission for one full-plane gradient pass (the twin of
// plan_gtil_full's decode-side walk): swizzle-scan the accept GRID, set
// stream-order bitmap bits (little bit order == swizzle.pack_bitmap),
// first-touch-dedup the 4 tile corners against the 4x4-grid mapped set
// and append their precomputed posterized bytes corner-major/plane-minor
// (EncoderContext.cpp:4001-4133 semantics), and OR the tile footprint
// into the 4x4-block claim accumulator. corner_bytes/mapped4:
// [3, qh4, qw4] u8 (qh4 = h/4+1); claims4: [h/4, w/4] u8 or null.
// Returns the accepted-tile count; *rgb_len_out = bytes appended.
int64_t emit_gtil_pass(const uint8_t* accept, int w, int h, int sx, int sy,
                       int bx, int by, const uint8_t* corner_bytes,
                       uint8_t* mapped4, uint8_t* claims4,
                       uint8_t* bitmap_out, uint8_t* rgb_out,
                       int64_t* rgb_len_out, int32_t* tile_bbox) {
    const int tw = 1 << sx, th = 1 << sy;
    const int ntx = (w + tw - 1) / tw;
    const int nbx = (w + bx - 1) / bx, nby = (h + by - 1) / by;
    const int colsw = bx >> sx, rowsw = by >> sy;
    const int bits_per_word = colsw * rowsw;
    const int64_t total_bits = (int64_t)nbx * nby * bits_per_word;
    const int64_t qw4 = w / 4 + 1, qh4 = h / 4 + 1;
    const int64_t cplane = qh4 * qw4;
    const int cqw = tw / 4, cqh = th / 4;   // corner stride on the 4-grid
    const int64_t w4 = w / 4;

    int64_t count = 0, rcur = 0;
    int32_t mnx = 1 << 30, mny = 1 << 30, mxx = -1, mxy = -1;
    for (int64_t k = 0; k < total_bits; ++k) {
        const int64_t big = k / bits_per_word;
        const int within = (int)(k % bits_per_word);
        const int tx = (int)(big % nbx) * colsw + within % colsw;
        const int ty = (int)(big / nbx) * rowsw + within / colsw;
        if ((int64_t)(tx + 1) * tw > w || (int64_t)(ty + 1) * th > h)
            continue;
        if (!accept[(int64_t)ty * ntx + tx]) continue;
        bitmap_out[k >> 3] |= (uint8_t)(1u << (k & 7));
        ++count;
        if (tx < mnx) mnx = tx;
        if (tx > mxx) mxx = tx;
        if (ty < mny) mny = ty;
        if (ty > mxy) mxy = ty;
        const int64_t cx = (int64_t)tx * cqw, cy = (int64_t)ty * cqh;
        const int64_t ids[4] = {cy * qw4 + cx, cy * qw4 + cx + cqw,
                                (cy + cqh) * qw4 + cx,
                                (cy + cqh) * qw4 + cx + cqw};
        for (int c = 0; c < 4; ++c) {
            const int64_t id = ids[c];
            for (int pl = 0; pl < 3; ++pl) {
                uint8_t* mp = mapped4 + pl * cplane;
                if (!mp[id]) {
                    mp[id] = 1;
                    rgb_out[rcur++] = corner_bytes[pl * cplane + id];
                }
            }
        }
        if (claims4) {
            for (int qy = 0; qy < cqh; ++qy)
                memset(claims4 + (cy + qy) * w4 + cx, 1, cqw);
        }
    }
    *rgb_len_out = rcur;
    tile_bbox[0] = mnx; tile_bbox[1] = mny;
    tile_bbox[2] = mxx; tile_bbox[3] = mxy;
    return count;
}

// Claim the quad footprints of n accepted tiles (GTIL passes).
void claim_tiles(int64_t n, const int32_t* qx0, const int32_t* qy0,
                 int tqw, int tqh, uint8_t* claims, int64_t qh,
                 int64_t qw_stride) {
    for (int64_t i = 0; i < n; ++i)
        for (int qy = 0; qy < tqh; ++qy)
            for (int qx = 0; qx < tqw; ++qx) {
                int64_t y = qy0[i] + qy, x = qx0[i] + qx;
                if (y < qh && x < qw_stride)
                    claims[y * qw_stride + x] = 1;
            }
}

}  // extern "C"

/* CABAC slice-data encoder (ITU-T H.264 9.3) — native host finalization
 * tier of the x264_tpu framework.
 *
 * The device pipeline emits per-MB syntax tensors (modes, mvd, cbp,
 * zigzagged coefficient levels); this module runs the inherently serial
 * adaptive binary arithmetic coding over them.  The engine follows the
 * spec's PutBit/renorm formulation (9.3.4.2-9.3.4.6); context derivations
 * mirror the normative rules (9.3.3.1) as realized by the reference
 * encoder (reference encoder/cabac.c studied for behavior; re-implemented
 * here).  Context init / LPS-range / transition constants are the
 * normative tables in cabac_tables.h.
 *
 * Coverage: P/I/B slices with I_16x16, I_NxN, P_L0 16x16/16x8/8x16,
 * P_8x8 (P_L0_8x8 sub-partitions), P_Skip, B 16x16 MB types, 4:2:0,
 * frame coding; High-profile 8x8 transform on inter MBs
 * (transform_size_8x8_flag 9.3.3.1.1.10 + ctxBlockCat-5 residuals).
 * Build: gcc -O2 -shared -fPIC cabac.c -o libx264tpu_cabac.so
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#include "cabac_tables.h"

/* ---------------- arithmetic engine (9.3.4) ---------------- */

typedef struct {
    uint32_t low, range;
    int bits_outstanding, first_bit;
    uint8_t *buf;
    long bitpos, bitcap;
    int overflow;
    uint8_t state[1024];
} cab_t;

static void put_raw_bit(cab_t *c, int b)
{
    if (c->bitpos >= c->bitcap) { c->overflow = 1; return; }
    if (b)
        c->buf[c->bitpos >> 3] |= (uint8_t)(1u << (7 - (c->bitpos & 7)));
    c->bitpos++;
}

static void put_bit(cab_t *c, int b)
{
    if (c->first_bit)
        c->first_bit = 0;
    else
        put_raw_bit(c, b);
    while (c->bits_outstanding > 0) {
        put_raw_bit(c, !b);
        c->bits_outstanding--;
    }
}

static void renorm(cab_t *c)
{
    while (c->range < 256) {
        if (c->low >= 512) {
            c->low -= 512;
            put_bit(c, 1);
        } else if (c->low < 256) {
            put_bit(c, 0);
        } else {
            c->low -= 256;
            c->bits_outstanding++;
        }
        c->range <<= 1;
        c->low <<= 1;
    }
}

static void enc_dec(cab_t *c, int ctx, int b)
{
    int st = c->state[ctx];
    int lps = cabac_range_lps[st >> 1][(c->range >> 6) & 3];
    c->range -= (uint32_t)lps;
    if (b != (st & 1)) {
        c->low += c->range;
        c->range = (uint32_t)lps;
    }
    c->state[ctx] = cabac_transition[st][b];
    renorm(c);
}

static void enc_bypass(cab_t *c, int b)
{
    c->low <<= 1;
    if (b)
        c->low += c->range;
    if (c->low >= 1024) {
        put_bit(c, 1);
        c->low -= 1024;
    } else if (c->low < 512) {
        put_bit(c, 0);
    } else {
        c->low -= 512;
        c->bits_outstanding++;
    }
}

static void enc_terminate(cab_t *c, int b)
{
    c->range -= 2;
    if (b) {
        c->low += c->range;
        /* EncodeFlush (9.3.4.6) */
        c->range = 2;
        renorm(c);
        put_bit(c, (c->low >> 9) & 1);
        put_raw_bit(c, (c->low >> 8) & 1);
        put_raw_bit(c, 1);            /* rbsp stop bit */
    } else {
        renorm(c);
    }
}

static void put_ue_bypass(cab_t *c, int k, uint32_t val)
{
    while (val >= (1u << k)) {
        enc_bypass(c, 1);
        val -= 1u << k;
        k++;
    }
    enc_bypass(c, 0);
    while (k--)
        enc_bypass(c, (int)((val >> k) & 1));
}

static void ctx_init(cab_t *c, int is_i_slice, int init_idc, int qp)
{
    const signed char (*tab)[2] = is_i_slice ? cabac_ctx_init_I
                                             : cabac_ctx_init_PB[init_idc];
    for (int j = 0; j < 1024; j++) {
        int s = ((tab[j][0] * qp) >> 4) + tab[j][1];
        if (s < 1) s = 1;
        if (s > 126) s = 126;
        int mn = s < 127 - s ? s : 127 - s;
        c->state[j] = (uint8_t)((mn << 1) | (s >> 6));
    }
}

/* ---------------- residual block (9.3.2.7 / 9.3.3.1.3) ---------------- */

/* cat: 0 luma DC (I16), 1 luma AC (I16), 2 luma 4x4, 3 chroma DC,
 * 4 chroma AC.  Normative context region offsets (frame coding). */
static const int SIG_OFF[5] = {105 + 0, 105 + 15, 105 + 29, 105 + 44,
                               105 + 47};
static const int LAST_OFF[5] = {166 + 0, 166 + 15, 166 + 29, 166 + 44,
                                166 + 47};
static const int LVL_OFF[5] = {227 + 0, 227 + 10, 227 + 20, 227 + 30,
                               227 + 39};
static const int CNT_M1[5] = {15, 14, 15, 3, 14};
static const int CBF_OFF[5] = {85, 89, 93, 97, 101};

static const uint8_t lvl1_ctx[8] = {1, 2, 3, 4, 0, 0, 0, 0};
static const uint8_t lvlgt1_ctx[8] = {5, 5, 5, 5, 6, 7, 8, 9};
static const uint8_t lvl_trans[2][8] = {
    {1, 2, 3, 3, 4, 5, 6, 7},
    {4, 4, 4, 4, 5, 6, 7, 7},
};

static void block_residual(cab_t *c, int cat, const int16_t *l)
{
    int count_m1 = CNT_M1[cat];
    int sig = SIG_OFF[cat], lastc = LAST_OFF[cat], lvl = LVL_OFF[cat];
    int last = count_m1;
    while (last > 0 && !l[last])
        last--;
    int16_t coeffs[16];
    int ci = -1;

    for (int i = 0;; i++) {
        if (l[i]) {
            coeffs[++ci] = l[i];
            enc_dec(c, sig + i, 1);
            if (i == last) {
                enc_dec(c, lastc + i, 1);
                break;
            }
            enc_dec(c, lastc + i, 0);
        } else {
            enc_dec(c, sig + i, 0);
        }
        if (i + 1 == count_m1) {
            coeffs[++ci] = l[i + 1];
            break;
        }
    }

    int node = 0;
    do {
        int v = coeffs[ci];
        int a = v < 0 ? -v : v;
        int ctx = lvl1_ctx[node] + lvl;
        if (a > 1) {
            enc_dec(c, ctx, 1);
            ctx = lvlgt1_ctx[node] + lvl;
            int m = a < 15 ? a : 15;
            for (int i = m - 2; i > 0; i--)
                enc_dec(c, ctx, 1);
            if (a < 15)
                enc_dec(c, ctx, 0);
            else
                put_ue_bypass(c, 0, (uint32_t)(a - 15));
            node = lvl_trans[1][node];
        } else {
            enc_dec(c, ctx, 0);
            node = lvl_trans[0][node];
        }
        enc_bypass(c, v < 0);
    } while (--ci >= 0);
}

/* ctxBlockCat 5: the 64-coefficient 8x8 luma residual (9.3.3.1.3 with
 * the Table 9-43 ctxIdxInc maps; level contexts at 426, shared scheme).
 * l: 64 levels in zigzag-64 scan order. */
static void block_residual_8x8(cab_t *c, const int16_t *l)
{
    int last = 63;
    while (last > 0 && !l[last])
        last--;
    int16_t coeffs[64];
    int ci = -1;

    for (int i = 0;; i++) {
        if (l[i]) {
            coeffs[++ci] = l[i];
            enc_dec(c, 402 + cabac_sig8x8_map[i], 1);
            if (i == last) {
                enc_dec(c, 417 + cabac_last8x8_map[i], 1);
                break;
            }
            enc_dec(c, 417 + cabac_last8x8_map[i], 0);
        } else {
            enc_dec(c, 402 + cabac_sig8x8_map[i], 0);
        }
        if (i + 1 == 63) {
            coeffs[++ci] = l[63];
            break;
        }
    }

    int node = 0;
    do {
        int v = coeffs[ci];
        int a = v < 0 ? -v : v;
        int ctx = lvl1_ctx[node] + 426;
        if (a > 1) {
            enc_dec(c, ctx, 1);
            ctx = lvlgt1_ctx[node] + 426;
            int m = a < 15 ? a : 15;
            for (int i = m - 2; i > 0; i--)
                enc_dec(c, ctx, 1);
            if (a < 15)
                enc_dec(c, ctx, 0);
            else
                put_ue_bypass(c, 0, (uint32_t)(a - 15));
            node = lvl_trans[1][node];
        } else {
            enc_dec(c, ctx, 0);
            node = lvl_trans[0][node];
        }
        enc_bypass(c, v < 0);
    } while (--ci >= 0);
}

/* Reassemble the zigzag-64 levels of 8x8 quadrant b8 from the CAVLC
 * interleave layout the device ships (raster-block-major cells; coded
 * cell i4 of quadrant q8 holds zigzag-64 positions 4*k+i4 — the inverse
 * of the 8.5.6 run interleave in models/residual_device.py). */
static void gather_t8_levels(const int16_t *lac_mb, int b8, int16_t *l64)
{
    static const uint8_t c2r[16] = {0, 1, 4, 5, 2, 3, 6, 7,
                                    8, 9, 12, 13, 10, 11, 14, 15};
    for (int i4 = 0; i4 < 4; i4++) {
        const int16_t *cell = lac_mb + 16 * c2r[4 * b8 + i4];
        for (int k = 0; k < 16; k++)
            l64[4 * k + i4] = cell[k];
    }
}

/* ---------------- per-MB syntax ---------------- */

#define CLS_I16 0
#define CLS_I4  1
#define CLS_P16 2
#define CLS_SKIP 3

/* coded (z-scan) order of the 16 luma 4x4 blocks -> raster index */
static const uint8_t ZSCAN2RASTER[16] =
    {0, 1, 4, 5, 2, 3, 6, 7, 8, 9, 12, 13, 10, 11, 14, 15};

typedef struct {
    int mbw, mbh, n;
    const int32_t *cls, *i16m, *chm, *mvd, *cbpl, *cbpc, *qp;
    const int16_t *ldc, *lac, *cdc, *cac;
    const int32_t *bmode, *mvd1;   /* B slices only */
    const int32_t *t8;   /* transform_size_8x8_flag per MB, or NULL */
    uint8_t *nnz;        /* (4mbh,4mbw) luma block cbf/nnz */
    uint8_t *cnnz[2];    /* (2mbh,2mbw) chroma AC cbf */
    uint8_t *dccbf;      /* (N,3): luma DC, chroma U DC, V DC cbf */
    uint8_t *amvd;       /* (N,2) capped |mvd| (list0) */
    uint8_t *amvd1;      /* (N,2) capped |mvd| (list1) */
    const int32_t *i4m;  /* (N,16) I4x4 pred modes, raster; NULL = no I4 */
    int8_t *i4grid;      /* (4mbh,4mbw) per-block mode chain (2 = non-I4) */
    const int32_t *ref;  /* (N,) list0 ref_idx, or NULL (single ref) */
    int num_ref;         /* active list0 size */
    /* P partitions (16x8/8x16/8x8), NULL when the frame is 16x16-only:
     * shape (N,) mb_type code 0-3; mvdp (N,4,2) per-partition-slot mvd in
     * decode order; refp (N,4) per-slot list0 ref.  Context neighbours
     * move to 8x8 granularity (9.3.3.1.1.6/.7 via the 6.4.11.7 partition
     * derivation): amvd8 (2mbh,2mbw,2) capped |mvd|, ref8 (2mbh,2mbw)
     * with intra/skip cells zeroed (condTermFlagN = 0 cases). */
    const int32_t *shape, *mvdp, *refp;
    uint8_t *amvd8;
    uint8_t *ref8;
} frame_t;

/* partition geometry (spec 7.4.5.2 decode order; quad q = 2*qy + qx) */
static const uint8_t PART_FIRSTQ[4][4] = {
    {0, 0, 0, 0}, {0, 2, 0, 0}, {0, 1, 0, 0}, {0, 1, 2, 3}};
static const uint8_t PART_OF_QUAD[4][4] = {
    {0, 0, 0, 0}, {0, 0, 1, 1}, {0, 1, 0, 1}, {0, 1, 2, 3}};
static const uint8_t PART_N[4] = {1, 2, 2, 4};

static int mb_intra(const frame_t *f, int mb)
{
    return f->cls[mb] == CLS_I16 || f->cls[mb] == CLS_I4;
}

static void write_mvd_comp(cab_t *c, int base, int ctx0, int mvd)
{
    static const uint8_t ctxes[8] = {3, 4, 5, 6, 6, 6, 6, 6};
    if (mvd == 0) {
        enc_dec(c, base + ctx0, 0);
        return;
    }
    int a = mvd < 0 ? -mvd : mvd;
    enc_dec(c, base + ctx0, 1);
    if (a < 9) {
        for (int i = 1; i < a; i++)
            enc_dec(c, base + ctxes[i - 1], 1);
        enc_dec(c, base + ctxes[a - 1], 0);
    } else {
        for (int i = 1; i < 9; i++)
            enc_dec(c, base + ctxes[i - 1], 1);
        put_ue_bypass(c, 3, (uint32_t)(a - 9));
    }
    enc_bypass(c, mvd < 0);
}

static void write_mb(cab_t *c, frame_t *f, int mb, int is_p,
                     int *last_qp, int *last_dqp)
{
    int mbx = mb % f->mbw, mby = mb / f->mbw;
    int has_l = mbx > 0, has_t = mby > 0;
    int mbl = mb - 1, mbt = mb - f->mbw;
    int cls = f->cls[mb];
    int intra = cls == CLS_I16 || cls == CLS_I4;
    int i16 = cls == CLS_I16;
    int cbp_l = f->cbpl[mb], cbp_c = f->cbpc[mb];
    int gx = 4 * mbx, gy = 4 * mby, gw = 4 * f->mbw;
    int cgx = 2 * mbx, cgy = 2 * mby, cgw = 2 * f->mbw;

    /* ---- mb_type ---- */
    if (is_p) {
        if (intra) {
            enc_dec(c, 14, 1);
            /* intra suffix, ctx 17..: bin0 0 = I_NxN, 1 = I_16x16 */
            if (cls == CLS_I4) {
                enc_dec(c, 17, 0);
            } else {
                enc_dec(c, 17, 1);
                enc_terminate(c, 0);
                enc_dec(c, 18, cbp_l != 0);
                if (cbp_c == 0) {
                    enc_dec(c, 19, 0);
                } else {
                    enc_dec(c, 19, 1);
                    enc_dec(c, 19, cbp_c >> 1);
                }
                int pm = f->i16m[mb];
                enc_dec(c, 20, pm >> 1);
                enc_dec(c, 20, pm & 1);
            }
        } else {
            /* P mb_type prefix (Table 9-34; ctx 14..17): 16x16 '000',
             * 16x8 '011', 8x16 '010', P_8x8 '001' */
            int sh = f->shape ? f->shape[mb] : 0;
            enc_dec(c, 14, 0);
            if (sh == 0)      { enc_dec(c, 15, 0); enc_dec(c, 16, 0); }
            else if (sh == 1) { enc_dec(c, 15, 1); enc_dec(c, 17, 1); }
            else if (sh == 2) { enc_dec(c, 15, 1); enc_dec(c, 17, 0); }
            else              { enc_dec(c, 15, 0); enc_dec(c, 16, 1); }
            if (sh == 3)
                for (int p = 0; p < 4; p++)
                    enc_dec(c, 21, 1);   /* sub_mb_type = P_L0_8x8 */
        }
    } else {
        /* 9.3.3.1.1.3: condTermFlagN = mbN available && mbN != I_NxN */
        int ctx = 0;
        if (has_l && f->cls[mbl] != CLS_I4) ctx++;
        if (has_t && f->cls[mbt] != CLS_I4) ctx++;
        if (cls == CLS_I4) {
            enc_dec(c, 3 + ctx, 0);
        } else {
            enc_dec(c, 3 + ctx, 1);
            enc_terminate(c, 0);
            enc_dec(c, 6, cbp_l != 0);
            if (cbp_c == 0) {
                enc_dec(c, 7, 0);
            } else {
                enc_dec(c, 7, 1);
                enc_dec(c, 8, cbp_c >> 1);
            }
            int pm = f->i16m[mb];
            enc_dec(c, 9, pm >> 1);
            enc_dec(c, 10, pm & 1);
        }
    }

    /* ---- I_NxN: transform_size_8x8_flag comes BEFORE the pred modes
     * (7.3.5); we never emit I8x8 so the flag is f->t8[mb] == 0 ---- */
    if (cls == CLS_I4 && f->t8) {
        int ctx = 399 + (has_l && f->t8[mbl] ? 1 : 0)
                      + (has_t && f->t8[mbt] ? 1 : 0);
        enc_dec(c, ctx, f->t8[mb] != 0);
    }
    if (cls == CLS_I4 && f->t8 && f->t8[mb]) {
        /* I8x8: 4 prev_intra8x8_pred_mode_flag + rem (same ctx 68/69 as
         * 4x4, 7.3.5.1/9.3.2.5), blocks in raster-quadrant order; the
         * mode chain reads the 4x4-grain grid at each quadrant's
         * top-left cell (8.3.2.1's Intra4x4PredMode mapping) */
        int ggw = 4 * f->mbw;
        for (int b8 = 0; b8 < 4; b8++) {
            int bgy = gy + (b8 >> 1) * 2, bgx = gx + (b8 & 1) * 2;
            int ma = bgx > 0 ? f->i4grid[bgy * ggw + bgx - 1] : -1;
            int mbv = bgy > 0 ? f->i4grid[(bgy - 1) * ggw + bgx] : -1;
            int pm = (ma < 0 || mbv < 0) ? 2 : (ma < mbv ? ma : mbv);
            int mode = f->i4m[16 * mb + b8];
            if (mode == pm) {
                enc_dec(c, 68, 1);
            } else {
                int v = mode < pm ? mode : mode - 1;
                enc_dec(c, 68, 0);
                enc_dec(c, 69, v & 1);
                enc_dec(c, 69, (v >> 1) & 1);
                enc_dec(c, 69, (v >> 2) & 1);
            }
        }
    } else if (cls == CLS_I4) {
        /* prev_intra4x4_pred_mode_flag (ctx 68) + rem (3 FL bins, ctx 69,
         * LSB first), blocks in coded z-scan order (7.3.5.1) */
        int ggw = 4 * f->mbw;
        for (int k = 0; k < 16; k++) {
            int r = ZSCAN2RASTER[k];
            int bgy = gy + (r >> 2), bgx = gx + (r & 3);
            int ma = bgx > 0 ? f->i4grid[bgy * ggw + bgx - 1] : -1;
            int mbv = bgy > 0 ? f->i4grid[(bgy - 1) * ggw + bgx] : -1;
            int pm = (ma < 0 || mbv < 0) ? 2 : (ma < mbv ? ma : mbv);
            int mode = f->i4m[16 * mb + r];
            if (mode == pm) {
                enc_dec(c, 68, 1);
            } else {
                int v = mode < pm ? mode : mode - 1;
                enc_dec(c, 68, 0);
                enc_dec(c, 69, v & 1);
                enc_dec(c, 69, (v >> 1) & 1);
                enc_dec(c, 69, (v >> 2) & 1);
            }
        }
    }

    if (intra) {
        /* intra_chroma_pred_mode: TU cMax 3, ctx 64+inc / 67 */
        int ctx = 0;
        if (has_l && mb_intra(f, mbl) && f->chm[mbl] != 0) ctx++;
        if (has_t && mb_intra(f, mbt) && f->chm[mbt] != 0) ctx++;
        int m = f->chm[mb];
        enc_dec(c, 64 + ctx, m > 0);
        if (m > 0) {
            enc_dec(c, 67, m > 1);
            if (m > 1)
                enc_dec(c, 67, m > 2);
        }
    } else if (f->shape) {
        /* partition-grain ref_idx + mvd: neighbours at 8x8 granularity
         * via the prefilled grids (left/top cells are decode-earlier by
         * geometry, so final-value prefill is order-safe) */
        int sh = f->shape[mb];
        int g2w = 2 * f->mbw;
        /* 7.3.5.2 order: ALL ref_idx_l0 first, THEN all mvd_l0 */
        if (f->num_ref > 1) {
            for (int p = 0; p < PART_N[sh]; p++) {
                int q = PART_FIRSTQ[sh][p];
                int cy = 2 * mby + (q >> 1), cx = 2 * mbx + (q & 1);
                int ra = cx > 0 && f->ref8[cy * g2w + cx - 1] > 0;
                int rb = cy > 0 && f->ref8[(cy - 1) * g2w + cx] > 0;
                int v = f->refp ? f->refp[4 * mb + p] : 0;
                int ctx = 54 + ra + 2 * rb;
                for (int i = 0;; i++) {
                    if (v == 0) {
                        enc_dec(c, ctx, 0);
                        break;
                    }
                    enc_dec(c, ctx, 1);
                    v--;
                    ctx = 54 + (i == 0 ? 4 : 5);
                }
            }
        }
        for (int p = 0; p < PART_N[sh]; p++) {
            int q = PART_FIRSTQ[sh][p];
            int cy = 2 * mby + (q >> 1), cx = 2 * mbx + (q & 1);
            int a0 = (cx > 0 ? f->amvd8[2 * (cy * g2w + cx - 1)] : 0)
                   + (cy > 0 ? f->amvd8[2 * ((cy - 1) * g2w + cx)] : 0);
            int a1 = (cx > 0 ? f->amvd8[2 * (cy * g2w + cx - 1) + 1] : 0)
                   + (cy > 0 ? f->amvd8[2 * ((cy - 1) * g2w + cx) + 1] : 0);
            write_mvd_comp(c, 40, (a0 > 2) + (a0 > 32),
                           f->mvdp[(4 * mb + p) * 2]);
            write_mvd_comp(c, 47, (a1 > 2) + (a1 > 32),
                           f->mvdp[(4 * mb + p) * 2 + 1]);
        }
    } else {
        if (f->num_ref > 1) {
            /* ref_idx_l0: unary bins, ctx 54 + inc (9.3.3.1.1.6:
             * condTermFlagN = 0 for unavailable / intra / skip /
             * refIdx 0 neighbours); bins 1 / >=2 use ctx 58 / 59 */
            int ra = has_l && f->cls[mbl] == CLS_P16 && f->ref
                     && f->ref[mbl] > 0;
            int rb = has_t && f->cls[mbt] == CLS_P16 && f->ref
                     && f->ref[mbt] > 0;
            int v = f->ref ? f->ref[mb] : 0;
            int ctx = 54 + ra + 2 * rb;
            for (int i = 0;; i++) {
                if (v == 0) {
                    enc_dec(c, ctx, 0);
                    break;
                }
                enc_dec(c, ctx, 1);
                v--;
                ctx = 54 + (i == 0 ? 4 : 5);
            }
        }
        /* mvd */
        int al = has_l && f->cls[mbl] == CLS_P16;
        int at = has_t && f->cls[mbt] == CLS_P16;
        int a0 = (al ? f->amvd[2 * mbl] : 0) + (at ? f->amvd[2 * mbt] : 0);
        int a1 = (al ? f->amvd[2 * mbl + 1] : 0)
               + (at ? f->amvd[2 * mbt + 1] : 0);
        int c0 = (a0 > 2) + (a0 > 32);
        int c1 = (a1 > 2) + (a1 > 32);
        write_mvd_comp(c, 40, c0, f->mvd[2 * mb]);
        write_mvd_comp(c, 47, c1, f->mvd[2 * mb + 1]);
    }

    /* ---- cbp (not coded for I16: it lives in mb_type) ---- */
    if (!i16) {
        int cl = has_l ? f->cbpl[mbl] : -1;
        int ct = has_t ? f->cbpl[mbt] : -1;
        /* bin b: ctx = 73 + (left bit absent->0) + 2*(top bit absent->0);
         * unavailable neighbours count as coded (x264's 76 - ... form) */
        enc_dec(c, 76 - ((cl >> 1) & 1) - ((ct >> 1) & 2), (cbp_l >> 0) & 1);
        enc_dec(c, 76 - ((cbp_l >> 0) & 1) - ((ct >> 2) & 2), (cbp_l >> 1) & 1);
        enc_dec(c, 76 - ((cl >> 3) & 1) - ((cbp_l << 1) & 2), (cbp_l >> 2) & 1);
        enc_dec(c, 76 - ((cbp_l >> 2) & 1) - ((cbp_l >> 0) & 2),
                (cbp_l >> 3) & 1);
        int ctx = 0;
        if (has_l && f->cbpc[mbl] > 0) ctx++;
        if (has_t && f->cbpc[mbt] > 0) ctx += 2;
        if (cbp_c == 0) {
            enc_dec(c, 77 + ctx, 0);
        } else {
            enc_dec(c, 77 + ctx, 1);
            ctx = 4;
            if (has_l && f->cbpc[mbl] == 2) ctx++;
            if (has_t && f->cbpc[mbt] == 2) ctx += 2;
            enc_dec(c, 77 + ctx, cbp_c >> 1);
        }
    }

    /* ---- transform_size_8x8_flag (7.3.5; 9.3.3.1.1.10: ctx 399 +
     * condTermFlagA + condTermFlagB from neighbour MB flags) ---- */
    if (f->t8 && !intra && cbp_l) {
        int ctx = 399 + (has_l && f->t8[mbl] ? 1 : 0)
                      + (has_t && f->t8[mbt] ? 1 : 0);
        enc_dec(c, ctx, f->t8[mb] != 0);
    }

    /* ---- mb_qp_delta ---- */
    if (cbp_l || cbp_c || i16) {
        int dqp = f->qp[mb] - *last_qp;
        if (dqp > 25) dqp -= 52;
        else if (dqp < -26) dqp += 52;
        int prev_res = mb > 0 && f->cls[mb - 1] != CLS_SKIP
                       && (f->cls[mb - 1] == CLS_I16
                           || f->cbpl[mb - 1] || f->cbpc[mb - 1]);
        int ctx = (*last_dqp != 0) && prev_res;
        int val = dqp > 0 ? 2 * dqp - 1 : -2 * dqp;
        for (int i = 0; i < val; i++) {
            enc_dec(c, 60 + ctx, 1);
            ctx = 2 + (ctx >> 1);
        }
        enc_dec(c, 60 + ctx, 0);
        *last_qp = f->qp[mb];
        *last_dqp = dqp;
    } else {
        *last_dqp = 0;
    }

    /* ---- residuals ---- */
    /* coded_block_flag neighbour inference: unavailable -> intra?1:0 */
#define NNZ_L(ggx, ggy, grid, ggw) \
    ((ggx) > 0 ? grid[(ggy) * (ggw) + (ggx) - 1] != 0 : (uint8_t)intra)
#define NNZ_T(ggx, ggy, grid, ggw) \
    ((ggy) > 0 ? grid[((ggy) - 1) * (ggw) + (ggx)] != 0 : (uint8_t)intra)

    if (i16) {
        /* luma DC: cbf neighbours = DC cbf of A/B MBs (intra-inferred) */
        int nza = has_l ? f->dccbf[3 * mbl] : 1;
        int nzb = has_t ? f->dccbf[3 * mbt] : 1;
        /* non-I16 neighbour MBs have no luma DC block: cbf 0 */
        if (has_l && f->cls[mbl] != CLS_I16) nza = 0;
        if (has_t && f->cls[mbt] != CLS_I16) nzb = 0;
        int cbf = f->dccbf[3 * mb];
        enc_dec(c, CBF_OFF[0] + nza + 2 * nzb, cbf);
        if (cbf)
            block_residual(c, 0, f->ldc + 16 * mb);
    }
    if (cbp_l && f->t8 && f->t8[mb]) {
        /* 8x8 transform: no per-block coded_block_flag (the CBP bit is
         * the coded indicator); one ctxBlockCat-5 residual per 8x8 */
        int16_t l64[64];
        for (int b8 = 0; b8 < 4; b8++)
            if ((cbp_l >> b8) & 1) {
                gather_t8_levels(f->lac + 256 * mb, b8, l64);
                block_residual_8x8(c, l64);
            }
    } else if (cbp_l) {
        int cat = i16 ? 1 : 2;
        for (int b8 = 0; b8 < 4; b8++) {
            if (!((cbp_l >> b8) & 1))
                continue;
            for (int k = 0; k < 4; k++) {
                int r = (b8 >> 1) * 8 + (b8 & 1) * 2 + (k >> 1) * 4 + (k & 1);
                int bx = gx + (r & 3), by = gy + (r >> 2);
                int nza = NNZ_L(bx, by, f->nnz, gw);
                int nzb = NNZ_T(bx, by, f->nnz, gw);
                int cbf = f->nnz[by * gw + bx] != 0;
                enc_dec(c, CBF_OFF[cat] + nza + 2 * nzb, cbf);
                if (cbf) {
                    const int16_t *l = f->lac + (16 * mb + r) * 16;
                    block_residual(c, cat, i16 ? l + 1 : l);
                }
            }
        }
    }
    if (cbp_c) {
        for (int pl = 0; pl < 2; pl++) {
            int nza = has_l ? f->dccbf[3 * mbl + 1 + pl] : intra;
            int nzb = has_t ? f->dccbf[3 * mbt + 1 + pl] : intra;
            int cbf = f->dccbf[3 * mb + 1 + pl];
            enc_dec(c, CBF_OFF[3] + nza + 2 * nzb, cbf);
            if (cbf)
                block_residual(c, 3, f->cdc + (2 * mb + pl) * 4);
        }
    }
    if (cbp_c == 2) {
        for (int pl = 0; pl < 2; pl++) {
            for (int k = 0; k < 4; k++) {
                int bx = cgx + (k & 1), by = cgy + (k >> 1);
                const uint8_t *grid = f->cnnz[pl];
                int nza = NNZ_L(bx, by, grid, cgw);
                int nzb = NNZ_T(bx, by, grid, cgw);
                int cbf = grid[by * cgw + bx] != 0;
                enc_dec(c, CBF_OFF[4] + nza + 2 * nzb, cbf);
                if (cbf)
                    block_residual(c, 4, f->cac + ((2 * mb + pl) * 4 + k)
                                   * 16 + 1);
            }
        }
    }
#undef NNZ_L
#undef NNZ_T
}

/* ---- B-slice MB syntax (temporal direct, one ref per list, 16x16) ---- */
#define BM_DIRECT 0
#define BM_L0 1
#define BM_L1 2
#define BM_BI 3

static void write_mb_b(cab_t *c, frame_t *f, int mb,
                       int *last_qp, int *last_dqp)
{
    int mbx = mb % f->mbw, mby = mb / f->mbw;
    int has_l = mbx > 0, has_t = mby > 0;
    int mbl = mb - 1, mbt = mb - f->mbw;
    int mode = f->bmode[mb];
    int intra = f->cls[mb] == CLS_I16;
    int i16 = intra;
    int cbp_l = f->cbpl[mb], cbp_c = f->cbpc[mb];
    int gx = 4 * mbx, gy = 4 * mby, gw = 4 * f->mbw;
    int cgx = 2 * mbx, cgy = 2 * mby, cgw = 2 * f->mbw;

    /* mb_type: bin0 ctx from neighbours not direct/skip (9.3.3.1.1.3;
     * intra neighbours count as coded-non-direct) */
    int ctx = 0;
    if (has_l && !(f->cls[mbl] == CLS_SKIP
                   || (f->cls[mbl] != CLS_I16 && f->bmode[mbl] == BM_DIRECT)))
        ctx++;
    if (has_t && !(f->cls[mbt] == CLS_SKIP
                   || (f->cls[mbt] != CLS_I16 && f->bmode[mbt] == BM_DIRECT)))
        ctx++;
    if (i16) {
        /* intra escape (Table 9-37 rows 23+): prefix '111101' — binIdx1
         * ctx 30, binIdx2 ctx = 31 when b1==1 (the 5 - b1 rule the inter
         * paths below also use), binIdx3+ ctx 32 — then the I-slice
         * I_16x16 suffix at the B suffix contexts 32..35 (x264
         * encoder/cabac.c cabac_mb_type intra-in-B path) */
        enc_dec(c, 27 + ctx, 1);
        enc_dec(c, 27 + 3, 1);
        enc_dec(c, 27 + 4, 1);
        enc_dec(c, 27 + 5, 1);
        enc_dec(c, 27 + 5, 0);
        enc_dec(c, 27 + 5, 1);
        enc_dec(c, 32, 1);           /* I_16x16, not I_NxN */
        enc_terminate(c, 0);         /* not I_PCM */
        enc_dec(c, 33, cbp_l != 0);
        if (cbp_c == 0) {
            enc_dec(c, 34, 0);
        } else {
            enc_dec(c, 34, 1);
            enc_dec(c, 34, cbp_c >> 1);
        }
        int pm = f->i16m[mb];
        enc_dec(c, 35, pm >> 1);
        enc_dec(c, 35, pm & 1);
        /* intra_chroma_pred_mode: TU cMax 3, ctx 64+inc / 67 */
        int cctx = 0;
        if (has_l && mb_intra(f, mbl) && f->chm[mbl] != 0) cctx++;
        if (has_t && mb_intra(f, mbt) && f->chm[mbt] != 0) cctx++;
        int m = f->chm[mb];
        enc_dec(c, 64 + cctx, m > 0);
        if (m > 0) {
            enc_dec(c, 67, m > 1);
            if (m > 1)
                enc_dec(c, 67, m > 2);
        }
    } else if (mode == BM_DIRECT) {
        enc_dec(c, 27 + ctx, 0);
    } else {
        enc_dec(c, 27 + ctx, 1);
        int bits = mode == BM_L0 ? 0x4 : mode == BM_L1 ? 0x6 : 0x21;
        enc_dec(c, 27 + 3, bits & 1);
        enc_dec(c, 27 + 5 - (bits & 1), (bits >> 1) & 1);
        bits >>= 2;
        if (bits != 1) {
            enc_dec(c, 27 + 5, bits & 1); bits >>= 1;
            enc_dec(c, 27 + 5, bits & 1); bits >>= 1;
            enc_dec(c, 27 + 5, bits & 1); bits >>= 1;
            if (bits != 1)
                enc_dec(c, 27 + 5, bits & 1);
        }
        /* no ref_idx bins (one reference per list); mvd per used list */
        int use0 = mode == BM_L0 || mode == BM_BI;
        int use1 = mode == BM_L1 || mode == BM_BI;
        int al = has_l && f->cls[mbl] != CLS_SKIP;
        int at = has_t && f->cls[mbt] != CLS_SKIP;
        if (use0) {
            int a0 = (al ? f->amvd[2 * mbl] : 0)
                   + (at ? f->amvd[2 * mbt] : 0);
            int a1 = (al ? f->amvd[2 * mbl + 1] : 0)
                   + (at ? f->amvd[2 * mbt + 1] : 0);
            write_mvd_comp(c, 40, (a0 > 2) + (a0 > 32), f->mvd[2 * mb]);
            write_mvd_comp(c, 47, (a1 > 2) + (a1 > 32), f->mvd[2 * mb + 1]);
        }
        if (use1) {
            int a0 = (al ? f->amvd1[2 * mbl] : 0)
                   + (at ? f->amvd1[2 * mbt] : 0);
            int a1 = (al ? f->amvd1[2 * mbl + 1] : 0)
                   + (at ? f->amvd1[2 * mbt + 1] : 0);
            write_mvd_comp(c, 40, (a0 > 2) + (a0 > 32), f->mvd1[2 * mb]);
            write_mvd_comp(c, 47, (a1 > 2) + (a1 > 32), f->mvd1[2 * mb + 1]);
        }
    }

    /* cbp (not coded for I16: it lives in mb_type) */
    if (!i16) {
        int cl = has_l ? f->cbpl[mbl] : -1;
        int ct = has_t ? f->cbpl[mbt] : -1;
        enc_dec(c, 76 - ((cl >> 1) & 1) - ((ct >> 1) & 2), (cbp_l >> 0) & 1);
        enc_dec(c, 76 - ((cbp_l >> 0) & 1) - ((ct >> 2) & 2), (cbp_l >> 1) & 1);
        enc_dec(c, 76 - ((cl >> 3) & 1) - ((cbp_l << 1) & 2), (cbp_l >> 2) & 1);
        enc_dec(c, 76 - ((cbp_l >> 2) & 1) - ((cbp_l >> 0) & 2),
                (cbp_l >> 3) & 1);
        int cc = 0;
        if (has_l && f->cbpc[mbl] > 0) cc++;
        if (has_t && f->cbpc[mbt] > 0) cc += 2;
        if (cbp_c == 0) {
            enc_dec(c, 77 + cc, 0);
        } else {
            enc_dec(c, 77 + cc, 1);
            cc = 4;
            if (has_l && f->cbpc[mbl] == 2) cc++;
            if (has_t && f->cbpc[mbt] == 2) cc += 2;
            enc_dec(c, 77 + cc, cbp_c >> 1);
        }
    }

    /* transform_size_8x8_flag: the PPS advertises 8x8 mode, so every
     * coded-luma INTER MB carries the bin (B_Direct included,
     * direct_8x8_inference_flag=1; I16 has none) */
    if (f->t8 && cbp_l && !i16) {
        int tctx = 399 + (has_l && f->t8[mbl] ? 1 : 0)
                       + (has_t && f->t8[mbt] ? 1 : 0);
        enc_dec(c, tctx, f->t8[mb] != 0);
    }

    /* mb_qp_delta */
    if (cbp_l || cbp_c || i16) {
        int dqp = f->qp[mb] - *last_qp;
        if (dqp > 25) dqp -= 52;
        else if (dqp < -26) dqp += 52;
        int prev_res = mb > 0 && f->cls[mb - 1] != CLS_SKIP
                       && (f->cls[mb - 1] == CLS_I16
                           || f->cbpl[mb - 1] || f->cbpc[mb - 1]);
        int ctx2 = (*last_dqp != 0) && prev_res;
        int val = dqp > 0 ? 2 * dqp - 1 : -2 * dqp;
        for (int i = 0; i < val; i++) {
            enc_dec(c, 60 + ctx2, 1);
            ctx2 = 2 + (ctx2 >> 1);
        }
        enc_dec(c, 60 + ctx2, 0);
        *last_qp = f->qp[mb];
        *last_dqp = dqp;
    } else {
        *last_dqp = 0;
    }

    /* residuals (inter cats 2/3/4; I16 escapes add cats 0/1 with the
     * intra cbf inference, same as the P writer) */
#define NNZ_L(ggx, ggy, grid, ggw) \
    ((ggx) > 0 ? grid[(ggy) * (ggw) + (ggx) - 1] != 0 : (uint8_t)intra)
#define NNZ_T(ggx, ggy, grid, ggw) \
    ((ggy) > 0 ? grid[((ggy) - 1) * (ggw) + (ggx)] != 0 : (uint8_t)intra)

    if (i16) {
        int nza = has_l ? f->dccbf[3 * mbl] : 1;
        int nzb = has_t ? f->dccbf[3 * mbt] : 1;
        if (has_l && f->cls[mbl] != CLS_I16) nza = 0;
        if (has_t && f->cls[mbt] != CLS_I16) nzb = 0;
        int cbf = f->dccbf[3 * mb];
        enc_dec(c, CBF_OFF[0] + nza + 2 * nzb, cbf);
        if (cbf)
            block_residual(c, 0, f->ldc + 16 * mb);
    }
    if (cbp_l && f->t8 && f->t8[mb] && !i16) {
        /* 8x8 transform: no per-block coded_block_flag (the CBP bit is
         * the coded indicator); one ctxBlockCat-5 residual per 8x8 */
        int16_t l64[64];
        for (int b8 = 0; b8 < 4; b8++)
            if ((cbp_l >> b8) & 1) {
                gather_t8_levels(f->lac + 256 * mb, b8, l64);
                block_residual_8x8(c, l64);
            }
    } else if (cbp_l) {
        for (int b8 = 0; b8 < 4; b8++) {
            if (!((cbp_l >> b8) & 1))
                continue;
            for (int k = 0; k < 4; k++) {
                int r = (b8 >> 1) * 8 + (b8 & 1) * 2 + (k >> 1) * 4 + (k & 1);
                int bx = gx + (r & 3), by = gy + (r >> 2);
                int nza = NNZ_L(bx, by, f->nnz, gw);
                int nzb = NNZ_T(bx, by, f->nnz, gw);
                int cbf = f->nnz[by * gw + bx] != 0;
                int cat = i16 ? 1 : 2;
                enc_dec(c, CBF_OFF[cat] + nza + 2 * nzb, cbf);
                if (cbf) {
                    const int16_t *l = f->lac + (16 * mb + r) * 16;
                    block_residual(c, cat, i16 ? l + 1 : l);
                }
            }
        }
    }
    if (cbp_c) {
        for (int pl = 0; pl < 2; pl++) {
            int nza = has_l ? f->dccbf[3 * mbl + 1 + pl] : intra;
            int nzb = has_t ? f->dccbf[3 * mbt + 1 + pl] : intra;
            int cbf = f->dccbf[3 * mb + 1 + pl];
            enc_dec(c, CBF_OFF[3] + nza + 2 * nzb, cbf);
            if (cbf)
                block_residual(c, 3, f->cdc + (2 * mb + pl) * 4);
        }
    }
    if (cbp_c == 2) {
        for (int pl = 0; pl < 2; pl++) {
            for (int k = 0; k < 4; k++) {
                int bx = cgx + (k & 1), by = cgy + (k >> 1);
                const uint8_t *grid = f->cnnz[pl];
                int nza = NNZ_L(bx, by, grid, cgw);
                int nzb = NNZ_T(bx, by, grid, cgw);
                int cbf = grid[by * cgw + bx] != 0;
                enc_dec(c, CBF_OFF[4] + nza + 2 * nzb, cbf);
                if (cbf)
                    block_residual(c, 4, f->cac + ((2 * mb + pl) * 4 + k)
                                   * 16 + 1);
            }
        }
    }
#undef NNZ_L
#undef NNZ_T
}

/* Returns payload byte count (the stream starts byte-aligned and includes
 * the rbsp stop bit), or -1 on overflow / bad input. */
long encode_slice_cabac(
    int mbw, int mbh, int slice_kind /*0=I,1=P,2=B*/, int slice_qp,
    int init_idc,
    const int32_t *cls, const int32_t *i16m, const int32_t *chm,
    const int32_t *mvd, const int32_t *cbpl, const int32_t *cbpc,
    const int32_t *qp_mb,
    const int16_t *ldc, const int16_t *lac,
    const int16_t *cdc, const int16_t *cac,
    const int32_t *bmode, const int32_t *mvd1,
    const int32_t *t8, const int32_t *i4m,
    const int32_t *ref, int num_ref,
    const int32_t *shape, const int32_t *mvdp, const int32_t *refp,
    uint8_t *out, long out_cap, uint8_t *state_out)
{
    int n = mbw * mbh;
    int is_p = slice_kind == 1, is_b = slice_kind == 2;
    frame_t f = {mbw, mbh, n, cls, i16m, chm, mvd, cbpl, cbpc, qp_mb,
                 ldc, lac, cdc, cac, bmode, mvd1, t8,
                 NULL, {NULL, NULL}, NULL, NULL, NULL, i4m, NULL,
                 ref, num_ref, shape, mvdp, refp, NULL, NULL};
    f.nnz = calloc((size_t)(16 * n), 1);
    f.cnnz[0] = calloc((size_t)(4 * n), 1);
    f.cnnz[1] = calloc((size_t)(4 * n), 1);
    f.dccbf = calloc((size_t)(3 * n), 1);
    f.amvd = calloc((size_t)(2 * n), 1);
    f.amvd1 = calloc((size_t)(2 * n), 1);
    f.i4grid = malloc((size_t)(16 * n));
    f.amvd8 = shape ? calloc((size_t)(8 * n), 1) : NULL;
    f.ref8 = shape ? calloc((size_t)(4 * n), 1) : NULL;
    if (!f.nnz || !f.cnnz[0] || !f.cnnz[1] || !f.dccbf || !f.amvd
        || !f.amvd1 || !f.i4grid || (shape && (!f.amvd8 || !f.ref8)))
        return -1;

    int gw = 4 * mbw, cgw = 2 * mbw;
    for (int mb = 0; mb < n; mb++) {
        int mbx = mb % mbw, mby = mb / mbw;
        int intra = cls[mb] == CLS_I16;
        /* per-block chosen-mode grid for predIntra4x4PredMode: the chain
         * only looks left/up (decode-order earlier), so prefilling the
         * whole grid from the inputs is order-safe */
        int mb_t8 = t8 && t8[mb];
        for (int r = 0; r < 16; r++) {
            /* I8x8 MBs replicate each quadrant's 8x8 mode to its 4
             * cells (8.3.2.1's Intra4x4PredMode mapping); modes live in
             * i4m slots 0-3 then */
            int src = mb_t8 ? ((r >> 3) * 2 + ((r & 3) >> 1)) : r;
            f.i4grid[(4 * mby + (r >> 2)) * gw + 4 * mbx + (r & 3)] =
                (int8_t)(cls[mb] == CLS_I4 && i4m ? i4m[16 * mb + src] : 2);
        }
        int cellcnt[16], qsum[4] = {0, 0, 0, 0};
        for (int r = 0; r < 16; r++) {
            const int16_t *l = lac + (16 * mb + r) * 16;
            int cnt = 0;
            for (int i = intra ? 1 : 0; i < 16; i++)
                cnt += l[i] != 0;
            /* only blocks in coded 8x8s carry cbf */
            int b8 = (r >> 3) * 2 + ((r & 3) >> 1);
            if (!((cbpl[mb] >> b8) & 1))
                cnt = 0;
            cellcnt[r] = cnt;
            qsum[b8] += cnt;
        }
        for (int r = 0; r < 16; r++) {
            /* 8x8-coded MBs: neighbour cbf derivation (9.3.3.1.1.9)
             * uses the containing transform block's coded state, so
             * every cell carries the quadrant total */
            int b8 = (r >> 3) * 2 + ((r & 3) >> 1);
            int cnt = (t8 && t8[mb]) ? qsum[b8] : cellcnt[r];
            f.nnz[(4 * mby + (r >> 2)) * gw + 4 * mbx + (r & 3)] =
                (uint8_t)(cnt > 255 ? 255 : cnt);
        }
        for (int pl = 0; pl < 2; pl++) {
            int dcnz = 0;
            for (int i = 0; i < 4; i++)
                dcnz |= cdc[(2 * mb + pl) * 4 + i] != 0;
            f.dccbf[3 * mb + 1 + pl] = (uint8_t)(cbpc[mb] > 0 && dcnz);
            for (int k = 0; k < 4; k++) {
                const int16_t *l = cac + ((2 * mb + pl) * 4 + k) * 16;
                int cnt = 0;
                for (int i = 1; i < 16; i++)
                    cnt += l[i] != 0;
                if (cbpc[mb] != 2)
                    cnt = 0;
                f.cnnz[pl][(2 * mby + (k >> 1)) * cgw + 2 * mbx + (k & 1)] =
                    (uint8_t)cnt;
            }
        }
        if (intra) {
            int dcnz = 0;
            for (int i = 0; i < 16; i++)
                dcnz |= ldc[16 * mb + i] != 0;
            f.dccbf[3 * mb] = (uint8_t)dcnz;
        }
        int ax = mvd[2 * mb] < 0 ? -mvd[2 * mb] : mvd[2 * mb];
        int ay = mvd[2 * mb + 1] < 0 ? -mvd[2 * mb + 1] : mvd[2 * mb + 1];
        f.amvd[2 * mb] = (uint8_t)(ax > 66 ? 66 : ax);
        f.amvd[2 * mb + 1] = (uint8_t)(ay > 66 ? 66 : ay);
        if (shape) {
            /* 8x8-grain neighbour grids: intra cells stay 0 (9.3.3.1.1.7
             * absMvdCompN = 0 / 9.3.3.1.1.6 condTermFlagN = 0); skip
             * cells carry mvd 0 / ref 0 by classification */
            int sh = (cls[mb] == CLS_P16) ? shape[mb] : 0;
            int inter = cls[mb] == CLS_P16;
            int g2w = 2 * mbw;
            for (int q = 0; q < 4; q++) {
                int p = PART_OF_QUAD[sh][q];
                int cell = (2 * mby + (q >> 1)) * g2w + 2 * mbx + (q & 1);
                int mx = inter ? mvdp[(4 * mb + p) * 2] : 0;
                int my = inter ? mvdp[(4 * mb + p) * 2 + 1] : 0;
                if (mx < 0) mx = -mx;
                if (my < 0) my = -my;
                f.amvd8[2 * cell] = (uint8_t)(mx > 66 ? 66 : mx);
                f.amvd8[2 * cell + 1] = (uint8_t)(my > 66 ? 66 : my);
                f.ref8[cell] = (uint8_t)(inter && refp
                                         ? refp[4 * mb + p] : 0);
            }
        }
        if (is_b && mvd1) {
            int bx = mvd1[2 * mb] < 0 ? -mvd1[2 * mb] : mvd1[2 * mb];
            int by = mvd1[2 * mb + 1] < 0 ? -mvd1[2 * mb + 1]
                                          : mvd1[2 * mb + 1];
            f.amvd1[2 * mb] = (uint8_t)(bx > 66 ? 66 : bx);
            f.amvd1[2 * mb + 1] = (uint8_t)(by > 66 ? 66 : by);
        }
    }

    cab_t c;
    memset(&c, 0, sizeof(c));
    c.low = 0;
    c.range = 510;
    c.first_bit = 1;
    c.buf = out;
    c.bitcap = out_cap * 8;
    memset(out, 0, (size_t)out_cap);
    ctx_init(&c, slice_kind == 0, init_idc, slice_qp);

    int last_qp = slice_qp, last_dqp = 0;
    for (int mb = 0; mb < n; mb++) {
        if (is_p || is_b) {
            int mbx = mb % mbw, mby = mb / mbw;
            int inc = (mbx > 0 && cls[mb - 1] != CLS_SKIP)
                    + (mby > 0 && cls[mb - mbw] != CLS_SKIP);
            enc_dec(&c, (is_b ? 24 : 11) + inc, cls[mb] == CLS_SKIP);
        }
        if (cls[mb] != CLS_SKIP) {
            if (is_b)
                write_mb_b(&c, &f, mb, &last_qp, &last_dqp);
            else
                write_mb(&c, &f, mb, is_p, &last_qp, &last_dqp);
        } else {
            last_dqp = 0;
        }
        enc_terminate(&c, mb == n - 1);
    }

    free(f.nnz);
    free(f.cnnz[0]);
    free(f.cnnz[1]);
    free(f.dccbf);
    free(f.amvd);
    free(f.amvd1);
    free(f.i4grid);
    free(f.amvd8);
    free(f.ref8);
    if (c.overflow)
        return -1;
    if (state_out)
        memcpy(state_out, c.state, 1024);   /* trellis cost feedback */
    return (c.bitpos + 7) >> 3;
}

/* ---- packed-blob entry (device "phase 2" handoff) ----
 * Flat int32 layout (see ops/device/entropy_pack.py):
 *   n rows of `stride` words:
 *     [0:13)  significance bitmap over the 408-value emission order
 *             [ldc 16 | lac 256 | cdc 8 | cac 128]
 *     [13]    exclusive prefix of the MB's nonzero count into the stream
 *     [14:..) fields: cls, mvd_x, mvd_y, i16m, chm, cbpl, cbpc, qp,
 *             nnz, mb_cost, icost [, bmode, mvd1_x, mvd1_y], ref, t8
 *   then n*K/2 words: frame-global int16 level pairs (lo | hi<<16).
 * K = average levels-per-MB stream capacity.
 * Returns payload bytes, or -1 on error / stream overflow. */
long encode_slice_cabac_packed(
    int mbw, int mbh, int slice_kind, int slice_qp, int init_idc,
    const int32_t *blob, int K, int stride, int t8_mode, int num_ref,
    int parts, int i4,
    uint8_t *out, long out_cap, uint8_t *state_out)
{
    int n = mbw * mbh;
    int is_b = slice_kind == 2;
    int foff = 14;
    long stream_cap = (long)n * K;
    const int32_t *stream = blob + (size_t)n * stride;
    size_t sz16 = sizeof(int16_t), sz32 = sizeof(int32_t);
    int16_t *ldc = calloc((size_t)16 * n, sz16);
    int16_t *lac = calloc((size_t)256 * n, sz16);
    int16_t *cdc = calloc((size_t)8 * n, sz16);
    int16_t *cac = calloc((size_t)128 * n, sz16);
    int32_t *cls = malloc((size_t)n * sz32);
    int32_t *mvd = malloc((size_t)2 * n * sz32);
    int32_t *i16m = malloc((size_t)n * sz32);
    int32_t *chm = malloc((size_t)n * sz32);
    int32_t *cbpl = malloc((size_t)n * sz32);
    int32_t *cbpc = malloc((size_t)n * sz32);
    int32_t *qp = malloc((size_t)n * sz32);
    int32_t *bmode = is_b ? malloc((size_t)n * sz32) : NULL;
    int32_t *mvd1 = is_b ? malloc((size_t)2 * n * sz32) : NULL;
    int32_t *t8 = malloc((size_t)n * sz32);
    int32_t *ref = malloc((size_t)n * sz32);
    int32_t *shape = parts ? malloc((size_t)n * sz32) : NULL;
    int32_t *mvdp = parts ? malloc((size_t)8 * n * sz32) : NULL;
    int32_t *refp = parts ? malloc((size_t)4 * n * sz32) : NULL;
    int32_t *i4m = i4 ? malloc((size_t)16 * n * sz32) : NULL;
    long ret = -1;
    if (!ldc || !lac || !cdc || !cac || !cls || !mvd || !i16m || !chm
        || !cbpl || !cbpc || !qp || !t8 || !ref
        || (is_b && (!bmode || !mvd1))
        || (parts && (!shape || !mvdp || !refp))
        || (i4 && !i4m))
        goto done;

    for (int mb = 0; mb < n; mb++) {
        const int32_t *row = blob + (size_t)mb * stride;
        const int32_t *fields = row + foff;
        long prefix = row[13];
        if (prefix + fields[8] > stream_cap)
            goto done;             /* stream overflow: caller retries */
        cls[mb] = fields[0];
        mvd[2 * mb] = fields[1];
        mvd[2 * mb + 1] = fields[2];
        i16m[mb] = fields[3];
        chm[mb] = fields[4];
        cbpl[mb] = fields[5];
        cbpc[mb] = fields[6];
        qp[mb] = fields[7];
        if (is_b) {
            bmode[mb] = fields[11];
            mvd1[2 * mb] = fields[12];
            mvd1[2 * mb + 1] = fields[13];
        }
        ref[mb] = fields[is_b ? 14 : 11];
        t8[mb] = fields[is_b ? 15 : 12];
        if (parts) {
            /* partition tail fields (entropy_pack FIELDS_PARTS): shape,
             * mvd slots 1-3, refs 1-3; slot 0 rides the base fields */
            shape[mb] = fields[13];
            mvdp[8 * mb] = fields[1];
            mvdp[8 * mb + 1] = fields[2];
            for (int p = 1; p < 4; p++) {
                mvdp[8 * mb + 2 * p] = fields[14 + 2 * (p - 1)];
                mvdp[8 * mb + 2 * p + 1] = fields[15 + 2 * (p - 1)];
            }
            refp[4 * mb] = fields[11];
            refp[4 * mb + 1] = fields[20];
            refp[4 * mb + 2] = fields[21];
            refp[4 * mb + 3] = fields[22];
        }
        if (i4) {
            /* I_NxN pred-mode nibbles ride the LAST two row words */
            uint32_t lo = (uint32_t)row[stride - 2];
            uint32_t hi = (uint32_t)row[stride - 1];
            for (int k = 0; k < 8; k++) {
                i4m[16 * mb + k] = (int32_t)((lo >> (4 * k)) & 15);
                i4m[16 * mb + 8 + k] = (int32_t)((hi >> (4 * k)) & 15);
            }
        }
        int16_t *dst[4] = {ldc + 16 * mb, lac + 256 * mb,
                           cdc + 8 * mb, cac + 128 * mb};
        int lim[4] = {16, 256, 8, 128};
        int sec = 0, secbase = 0;
        long r = prefix;
        for (int j = 0; j < 408; j++) {
            while (j - secbase >= lim[sec]) { secbase += lim[sec]; sec++; }
            if ((row[j >> 5] >> (j & 31)) & 1) {
                int32_t w = stream[r >> 1];
                int16_t v = (int16_t)((r & 1) ? (w >> 16) : (w & 0xffff));
                dst[sec][j - secbase] = v;
                r++;
            }
        }
    }
    ret = encode_slice_cabac(mbw, mbh, slice_kind, slice_qp, init_idc,
                             cls, i16m, chm, mvd, cbpl, cbpc, qp,
                             ldc, lac, cdc, cac, bmode, mvd1,
                             t8_mode ? t8 : NULL, i4m,
                             ref, num_ref, shape, mvdp, refp,
                             out, out_cap, state_out);
done:
    free(ldc); free(lac); free(cdc); free(cac); free(cls); free(mvd);
    free(i16m); free(chm); free(cbpl); free(cbpc); free(qp); free(ref);
    free(bmode); free(mvd1); free(t8);
    free(shape); free(mvdp); free(refp); free(i4m);
    return ret;
}

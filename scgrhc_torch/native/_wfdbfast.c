/* _wfdbfast.c — the port's WFDB .dat decoder (plain C ABI, bound with ctypes
 * by scgrhc_torch/native/__init__.py).
 *
 * Fuses sample decoding (formats 16 / 24 / 32 / 61 / 80 / 160 / 212),
 * de-interleaving, invalid-sample sentinel mapping (NaN, like
 * wfdb.rdrecord), and per-signal baseline/gain calibration into a single
 * pass that writes float64 physical values straight into the caller's
 * (sig_len, out_stride) p_signal matrix, signal s into column cols[s].
 * The NumPy decode in scgrhc_torch/io/wfdb.py does the same work in several
 * vectorized passes with intermediate arrays.  Sentinels per the WFDB
 * spec: -32768 for fmt 16/61/160, -2147483648 for fmt 32, -8388608 for
 * fmt 24, -128 for fmt 80, -2048 for fmt 212.  The packed 10-bit formats
 * 310/311 and fmt 8, whose cumulative-difference decode is serial per
 * signal, stay on the NumPy path.
 *
 * Each value is ((double)v - baseline) / gain, a subtraction then a
 * division, so its bits equal NumPy's (block.astype(np.float64) - baseline)
 * / gain.  Build without -ffast-math: a reciprocal multiply would change
 * them.
 */
#include <math.h>
#include <stdint.h>
#include <stdlib.h>

enum {
    WFDB_OK = 0,
    WFDB_BAD_SIZE = 1,    /* n_sig <= 0 or sig_len < 0 */
    WFDB_BAD_FORMAT = 2,  /* not one of the formats above */
    WFDB_SHORT = 3,       /* the .dat holds fewer samples than the header promises */
    WFDB_NO_MEMORY = 4,
};

#define CAL(v, s) (((double)(v) - baselines[s]) / g[s])

/* Decode ``len`` bytes of ``raw`` in format ``fmt`` (n_sig interleaved
 * signals of sig_len samples each) into out[t * out_stride + cols[s]].
 * A gain of 0 reads as 200, the WFDB default.  *avail and *total receive
 * the samples the bytes hold and the samples the header promises (both
 * set before a WFDB_SHORT return).  Returns one of the codes above. */
int scgrhc_decode_calibrate(const uint8_t *raw, int64_t len, int fmt, int64_t n_sig,
                            int64_t sig_len, const double *baselines, const double *gains,
                            double *out, int64_t out_stride, const int64_t *cols,
                            int64_t *avail, int64_t *total)
{
    if (n_sig <= 0 || sig_len < 0)
        return WFDB_BAD_SIZE;
    switch (fmt) {
    case 16: case 61: case 160: *avail = len / 2; break;
    case 24: *avail = len / 3; break;
    case 32: *avail = len / 4; break;
    case 80: *avail = len; break;
    case 212: *avail = (len / 3) * 2; break;
    default: return WFDB_BAD_FORMAT;
    }
    *total = n_sig * sig_len;
    if (*avail < *total)
        return WFDB_SHORT;

    double *g = (double *)malloc(sizeof(double) * (size_t)n_sig);
    if (!g)
        return WFDB_NO_MEMORY;
    for (int64_t s = 0; s < n_sig; s++)
        g[s] = gains[s] == 0.0 ? 200.0 : gains[s];

    switch (fmt) {
    case 16:
        for (int64_t t = 0; t < sig_len; t++) {
            const uint8_t *p = raw + t * n_sig * 2;
            double *o = out + t * out_stride;
            for (int64_t s = 0; s < n_sig; s++) {
                int16_t v = (int16_t)(p[2 * s] | ((uint16_t)p[2 * s + 1] << 8));
                o[cols[s]] = v == INT16_MIN ? NAN : CAL(v, s);
            }
        }
        break;
    case 61: /* big-endian int16 */
        for (int64_t t = 0; t < sig_len; t++) {
            const uint8_t *p = raw + t * n_sig * 2;
            double *o = out + t * out_stride;
            for (int64_t s = 0; s < n_sig; s++) {
                int16_t v = (int16_t)(((uint16_t)p[2 * s] << 8) | p[2 * s + 1]);
                o[cols[s]] = v == INT16_MIN ? NAN : CAL(v, s);
            }
        }
        break;
    case 160: /* 16-bit offset binary: sample = u16le - 32768 */
        for (int64_t t = 0; t < sig_len; t++) {
            const uint8_t *p = raw + t * n_sig * 2;
            double *o = out + t * out_stride;
            for (int64_t s = 0; s < n_sig; s++) {
                int v = (int)(p[2 * s] | ((uint16_t)p[2 * s + 1] << 8)) - 32768;
                o[cols[s]] = v == -32768 ? NAN : CAL(v, s);
            }
        }
        break;
    case 24: /* little-endian 3-byte two's complement */
        for (int64_t t = 0; t < sig_len; t++) {
            const uint8_t *p = raw + t * n_sig * 3;
            double *o = out + t * out_stride;
            for (int64_t s = 0; s < n_sig; s++) {
                const uint8_t *q = p + 3 * s;
                int32_t v = (int32_t)((uint32_t)q[0] | ((uint32_t)q[1] << 8) |
                                      ((uint32_t)q[2] << 16));
                if (v > 0x7FFFFF)
                    v -= 0x1000000; /* sign-extend 24-bit */
                o[cols[s]] = v == -8388608 ? NAN : CAL(v, s);
            }
        }
        break;
    case 32:
        for (int64_t t = 0; t < sig_len; t++) {
            const uint8_t *p = raw + t * n_sig * 4;
            double *o = out + t * out_stride;
            for (int64_t s = 0; s < n_sig; s++) {
                const uint8_t *q = p + 4 * s;
                int32_t v = (int32_t)((uint32_t)q[0] | ((uint32_t)q[1] << 8) |
                                      ((uint32_t)q[2] << 16) | ((uint32_t)q[3] << 24));
                o[cols[s]] = v == INT32_MIN ? NAN : CAL(v, s);
            }
        }
        break;
    case 80: /* 8-bit offset binary */
        for (int64_t t = 0; t < sig_len; t++) {
            const uint8_t *p = raw + t * n_sig;
            double *o = out + t * out_stride;
            for (int64_t s = 0; s < n_sig; s++) {
                int v = (int)p[s] - 128;
                o[cols[s]] = v == -128 ? NAN : CAL(v, s);
            }
        }
        break;
    case 212: { /* 3 bytes -> 2 consecutive samples of the interleaved stream */
        int64_t t = 0, s = 0;
        for (int64_t k = 0; k < *total; k++) {
            const uint8_t *p = raw + (k >> 1) * 3;
            int v = (k & 1) == 0 ? ((p[1] & 0x0F) << 8) | p[0] : ((p[1] & 0xF0) << 4) | p[2];
            if (v > 2047)
                v -= 4096; /* sign-extend 12-bit */
            out[t * out_stride + cols[s]] = v == -2048 ? NAN : CAL(v, s);
            if (++s == n_sig) {
                s = 0;
                t++;
            }
        }
        break;
    }
    }
    free(g);
    return WFDB_OK;
}

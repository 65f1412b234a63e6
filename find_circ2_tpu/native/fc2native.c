/* Native host-side data loader for the circRNA detection engine.
 *
 * Role: the reference pipeline's native I/O layer (samtools/htslib BAM
 * and FASTQ handling, SURVEY.md §2.2) rebuilt for this engine: scanning
 * FASTQ byte buffers into record offsets and encoding read batches into
 * the padded uint8 code arrays the device consumes. Called from Python
 * via ctypes (find_circ2_tpu/native/__init__.py); a pure-Python fallback
 * exists, this is the fast path for production streaming.
 *
 * Build: cc -O3 -shared -fPIC fc2native.c -o libfc2native.so
 */

#include <stdint.h>
#include <string.h>

/* Scan a FASTQ text buffer (no gzip; caller decompresses) and record,
 * for each read: name span, sequence span, quality span (byte offsets
 * into buf). Returns the number of records parsed, or -1 - <offset> on a
 * malformed record. Parsing stops at max_records or at a trailing
 * partial record (whose start offset is written to *resume_off so the
 * caller can refill the buffer and continue — streaming chunks).
 */
int64_t fc2_parse_fastq(const char *buf, int64_t len,
                        int64_t max_records,
                        int64_t *name_start, int64_t *name_end,
                        int64_t *seq_start, int64_t *seq_end,
                        int64_t *qual_start, int64_t *qual_end,
                        int64_t *resume_off) {
    int64_t i = 0, n = 0;
    *resume_off = 0;
    while (n < max_records) {
        int64_t rec_start = i;
        /* skip blank lines */
        while (i < len && (buf[i] == '\n' || buf[i] == '\r')) i++;
        rec_start = i;
        if (i >= len) { *resume_off = len; return n; }
        if (buf[i] != '@') return -1 - i;
        i++;
        int64_t ns = i;
        while (i < len && buf[i] != '\n' && buf[i] != ' '
               && buf[i] != '\t' && buf[i] != '\r') i++;
        int64_t ne = i;
        while (i < len && buf[i] != '\n') i++;       /* rest of header */
        if (i >= len) { *resume_off = rec_start; return n; }
        i++;
        int64_t ss = i;
        while (i < len && buf[i] != '\n' && buf[i] != '\r') i++;
        int64_t se = i;
        while (i < len && buf[i] != '\n') i++;
        if (i >= len) { *resume_off = rec_start; return n; }
        i++;
        if (i >= len) { *resume_off = rec_start; return n; }
        if (buf[i] != '+') return -1 - i;
        while (i < len && buf[i] != '\n') i++;       /* '+' line */
        if (i >= len) { *resume_off = rec_start; return n; }
        i++;
        int64_t qs = i;
        while (i < len && buf[i] != '\n' && buf[i] != '\r') i++;
        int64_t qe = i;
        while (i < len && buf[i] != '\n') i++;
        if (i >= len && qe - qs < se - ss) {          /* torn quality */
            *resume_off = rec_start; return n;
        }
        if (i < len) i++;
        if (qe - qs != se - ss) return -1 - qs;
        name_start[n] = ns; name_end[n] = ne;
        seq_start[n] = ss; seq_end[n] = se;
        qual_start[n] = qs; qual_end[n] = qe;
        n++;
        *resume_off = i;
    }
    return n;
}

/* Encode a batch of reads (byte spans into buf) into a padded uint8
 * code matrix out[n][lp] using lut[256]; lens[k] receives each true
 * length. Reads longer than lp are truncated to 0 length with
 * lens[k] = -(true length) so the caller can count/report them; pad
 * cells keep their prior value (caller pre-fills with RPAD).
 */
void fc2_encode_reads(const char *buf,
                      const int64_t *seq_start, const int64_t *seq_end,
                      int64_t n, int64_t lp,
                      unsigned char *out, int32_t *lens,
                      const unsigned char *lut) {
    for (int64_t k = 0; k < n; k++) {
        int64_t s = seq_start[k], e = seq_end[k];
        int64_t l = e - s;
        if (l > lp) { lens[k] = (int32_t)(-l); continue; }
        unsigned char *row = out + k * lp;
        for (int64_t j = 0; j < l; j++)
            row[j] = lut[(unsigned char)buf[s + j]];
        lens[k] = (int32_t)l;
    }
}

/* Reverse an array of codes into its complement in place-free form:
 * out[i] = comp[in[l-1-i]] for a batch row. Utility for host-side tools.
 */
void fc2_revcomp(const unsigned char *in, int64_t l,
                 const unsigned char *comp, unsigned char *out) {
    for (int64_t i = 0; i < l; i++)
        out[i] = comp[in[l - 1 - i]];
}

/* Segmented binary search over the seed index suffix array: for each
 * key i, the (left, right) insertion points of keys[i] within the
 * sorted uint16 segment sv[lo_b[i]:hi_b[i]).  The host 2-mm rescue
 * path (models/multihit._segmented_searchsorted) resolves the whole
 * enumerated variant ball through this — one tight loop instead of
 * vectorized numpy rounds (the reference leaned on bowtie2's C FM-index
 * walk for the same role, SURVEY.md §3.4).  right(k) == left(k+1) on
 * integer keys, and the right bound search resumes from the left bound.
 */
void fc2_segsearch(const uint16_t *sv, const int64_t *lo_b,
                   const int64_t *hi_b, const int64_t *keys, int64_t n,
                   int64_t *out_lo, int64_t *out_hi) {
    for (int64_t i = 0; i < n; i++) {
        int64_t lo = lo_b[i], hi = hi_b[i];
        const int64_t k = keys[i];
        while (lo < hi) {
            int64_t mid = (lo + hi) >> 1;
            if ((int64_t)sv[mid] < k) lo = mid + 1; else hi = mid;
        }
        out_lo[i] = lo;
        hi = hi_b[i];
        while (lo < hi) {
            int64_t mid = (lo + hi) >> 1;
            if ((int64_t)sv[mid] < k + 1) lo = mid + 1; else hi = mid;
        }
        out_hi[i] = lo;
    }
}

/* PNG row unfiltering for the Average (3) and Paeth (4) filters, in C.
 *
 * Both predict a byte from the reconstructed byte bpp to its left, so a row
 * is a serial recurrence that numpy cannot vectorise; one byte at a time in
 * Python it took hundreds of milliseconds a 576x720 frame.
 * ``tecogan_tpu_torch/data/png.py`` calls these once per row of those
 * types and keeps None, Sub and Up in numpy; its Python loops
 * (``_unfilter_average``, ``_unfilter_paeth``) are the plain version the
 * tests hold these to.
 *
 * Built with the host C compiler on first use into
 * tecogan_tpu_torch/_build/ (data/png.py) and loaded with ctypes, which
 * releases the GIL for the call.
 *
 * line: the row's filtered bytes (n), prev: the previous reconstructed row
 * (zeros for the first), out: the reconstructed row; bpp: bytes a pixel.
 */

#include <stdint.h>
#include <stdlib.h>

void tt_unfilter_average(const uint8_t *line, const uint8_t *prev, uint8_t *out,
                         int n, int bpp) {
    for (int i = 0; i < n; ++i) {
        int left = i >= bpp ? out[i - bpp] : 0;
        out[i] = (uint8_t)(line[i] + ((left + prev[i]) >> 1));
    }
}

void tt_unfilter_paeth(const uint8_t *line, const uint8_t *prev, uint8_t *out,
                       int n, int bpp) {
    for (int i = 0; i < n; ++i) {
        int a = i >= bpp ? out[i - bpp] : 0;
        int b = prev[i];
        int c = i >= bpp ? prev[i - bpp] : 0;
        int p = a + b - c;
        int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
        int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
        out[i] = (uint8_t)(line[i] + pred);
    }
}

/* Writes the arithmetic-coded and lossless JPEG fixtures with libjpeg-turbo
 * (the library PIL links): raw pixels on stdin, one file out.
 *
 *   make_jpeg_f4 OUT WIDTH HEIGHT COMPONENTS MODE [A B RESTART QUALITY]
 *
 * MODE arith: sequential arithmetic coding at QUALITY (default 85); A = 1
 *   4:4:4, 2 4:2:2, else the 4:2:0 default; B, where not 0, the DAC
 *   conditioning of every table: L = B & 7, U = (B >> 4) & 15,
 *   Kx = (B >> 8) & 63.
 * MODE arith_prog: the same with jpeg_simple_progression.
 * MODE lossless: predictor A (1-7), point transform B; QUALITY 1 or 2
 *   write YCbCr (2: 4:2:0) instead of the RGB jpeg_enable_lossless keeps.
 * RESTART: a restart interval in MCUs (0: none).
 *
 * libjpeg-turbo's jpeglib.h of this era does not declare
 * jpeg_enable_lossless, so it is declared here. Built and run by
 * make_image_fixtures.py against PIL's bundled libjpeg-turbo.
 */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <jpeglib.h>

void jpeg_enable_lossless(j_compress_ptr cinfo, int predictor_selection_value,
                          int point_transform);

int main(int argc, char** argv) {
  if (argc < 6) return 2;
  const char* out = argv[1];
  const int w = atoi(argv[2]), h = atoi(argv[3]), c = atoi(argv[4]);
  const char* mode = argv[5];
  const int a = argc > 6 ? atoi(argv[6]) : 0, b = argc > 7 ? atoi(argv[7]) : 0;
  const int restart = argc > 8 ? atoi(argv[8]) : 0;
  const int quality = argc > 9 ? atoi(argv[9]) : 85;
  unsigned char* px = malloc((size_t)w * h * c);
  if (fread(px, 1, (size_t)w * h * c, stdin) != (size_t)w * h * c) return 3;
  struct jpeg_compress_struct ci;
  struct jpeg_error_mgr jerr;
  ci.err = jpeg_std_error(&jerr);
  jpeg_create_compress(&ci);
  FILE* f = fopen(out, "wb");
  if (!f) return 4;
  jpeg_stdio_dest(&ci, f);
  ci.image_width = w;
  ci.image_height = h;
  ci.input_components = c;
  ci.in_color_space = c == 1 ? JCS_GRAYSCALE : JCS_RGB;
  jpeg_set_defaults(&ci);
  if (!strcmp(mode, "lossless")) {
    jpeg_enable_lossless(&ci, a, b);
    if (quality == 1 || quality == 2) jpeg_set_colorspace(&ci, JCS_YCbCr);
    if (quality == 2) ci.comp_info[0].h_samp_factor = ci.comp_info[0].v_samp_factor = 2;
  } else {
    jpeg_set_quality(&ci, quality, TRUE);
    ci.arith_code = TRUE;
    if (!strcmp(mode, "arith_prog")) jpeg_simple_progression(&ci);
    if (c == 3 && a == 1) {
      ci.comp_info[0].h_samp_factor = ci.comp_info[0].v_samp_factor = 1;
    } else if (c == 3 && a == 2) {
      ci.comp_info[0].h_samp_factor = 2;
      ci.comp_info[0].v_samp_factor = 1;
    }
    if (b) {
      for (int t = 0; t < NUM_ARITH_TBLS; t++) {
        ci.arith_dc_L[t] = (UINT8)(b & 7);
        ci.arith_dc_U[t] = (UINT8)((b >> 4) & 15);
        ci.arith_ac_K[t] = (UINT8)((b >> 8) & 63);
      }
    }
  }
  ci.restart_interval = restart;
  jpeg_start_compress(&ci, TRUE);
  while (ci.next_scanline < ci.image_height) {
    JSAMPROW row = px + (size_t)ci.next_scanline * w * c;
    jpeg_write_scanlines(&ci, &row, 1);
  }
  jpeg_finish_compress(&ci);
  fclose(f);
  jpeg_destroy_compress(&ci);
  free(px);
  return 0;
}

// WebP decoding for data/webp.py, which parses the RIFF container: the
// lossless bitstream (VP8L: prefix codes, colour cache, LZ77 with the 2-D
// distance map, the predictor, cross-colour, subtract-green and
// colour-indexing transforms), the lossy bitstream (VP8 key frames: the
// boolean decoder, segments, token partitions, intra prediction, the
// inverse WHT and DCT, the simple and normal loop filters), libwebp's fancy
// 4:2:0 upsampling and fixed-point YUV -> RGB, and the ALPH chunk's alpha
// plane (raw or lossless, with its prediction filters). Each step follows
// libwebp's C code (the reference decoder Pillow and OpenCV link), so the
// pixels are libwebp's bit for bit. The tables are the format's (RFC 6386
// and the lossless bitstream specification), as libwebp holds them.
// Each call runs in the calling thread.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

enum Err : int { kOk = 0, kCorrupt = 1, kTruncated = 2, kUnsupported = 3, kBadArgument = 5 };

constexpr uint8_t kCoeffsProba0[4][8][3][11] = {
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
    189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128,
    106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
    1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128,
    181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
    78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128,
    1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
    184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128,
    77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
    1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128,
    170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
    37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128,
    1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
    207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128,
    102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
    1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128,
    177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
    80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62,
    131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
    68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128,
    1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
    184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128,
    81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
    1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128,
    99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
    23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128,
    1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
    109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128,
    44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
    1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128,
    94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
    22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128,
    1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
    124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128,
    35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
    1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128,
    121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
    45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128,
    1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
    203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
    253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128,
    175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
    73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128,
    1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
    239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128,
    155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
    1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128,
    201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
    69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128,
    1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
    223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128,
    141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
    149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128,
    213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
    55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255,
    126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
    61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128,
    1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
    166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128,
    39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
    1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128,
    124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
    24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128,
    1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
    149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128,
    28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
    1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128,
    123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
    20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128,
    1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
    168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128,
    47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
    1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128,
    141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
    42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
};

constexpr uint8_t kCoeffsUpdateProba[4][8][3][11] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255,
    250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
    234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
    251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
};

constexpr uint8_t kBModesProba[10][10][9] = {
    231, 120, 48, 89, 115, 113, 120, 152, 112,
    152, 179, 64, 126, 170, 118, 46, 70, 95,
    175, 69, 143, 80, 85, 82, 72, 155, 103,
    56, 58, 10, 171, 218, 189, 17, 13, 152,
    114, 26, 17, 163, 44, 195, 21, 10, 173,
    121, 24, 80, 195, 26, 62, 44, 64, 85,
    144, 71, 10, 38, 171, 213, 144, 34, 26,
    170, 46, 55, 19, 136, 160, 33, 206, 71,
    63, 20, 8, 114, 114, 208, 12, 9, 226,
    81, 40, 11, 96, 182, 84, 29, 16, 36,
    134, 183, 89, 137, 98, 101, 106, 165, 148,
    72, 187, 100, 130, 157, 111, 32, 75, 80,
    66, 102, 167, 99, 74, 62, 40, 234, 128,
    41, 53, 9, 178, 241, 141, 26, 8, 107,
    74, 43, 26, 146, 73, 166, 49, 23, 157,
    65, 38, 105, 160, 51, 52, 31, 115, 128,
    104, 79, 12, 27, 217, 255, 87, 17, 7,
    87, 68, 71, 44, 114, 51, 15, 186, 23,
    47, 41, 14, 110, 182, 183, 21, 17, 194,
    66, 45, 25, 102, 197, 189, 23, 18, 22,
    88, 88, 147, 150, 42, 46, 45, 196, 205,
    43, 97, 183, 117, 85, 38, 35, 179, 61,
    39, 53, 200, 87, 26, 21, 43, 232, 171,
    56, 34, 51, 104, 114, 102, 29, 93, 77,
    39, 28, 85, 171, 58, 165, 90, 98, 64,
    34, 22, 116, 206, 23, 34, 43, 166, 73,
    107, 54, 32, 26, 51, 1, 81, 43, 31,
    68, 25, 106, 22, 64, 171, 36, 225, 114,
    34, 19, 21, 102, 132, 188, 16, 76, 124,
    62, 18, 78, 95, 85, 57, 50, 48, 51,
    193, 101, 35, 159, 215, 111, 89, 46, 111,
    60, 148, 31, 172, 219, 228, 21, 18, 111,
    112, 113, 77, 85, 179, 255, 38, 120, 114,
    40, 42, 1, 196, 245, 209, 10, 25, 109,
    88, 43, 29, 140, 166, 213, 37, 43, 154,
    61, 63, 30, 155, 67, 45, 68, 1, 209,
    100, 80, 8, 43, 154, 1, 51, 26, 71,
    142, 78, 78, 16, 255, 128, 34, 197, 171,
    41, 40, 5, 102, 211, 183, 4, 1, 221,
    51, 50, 17, 168, 209, 192, 23, 25, 82,
    138, 31, 36, 171, 27, 166, 38, 44, 229,
    67, 87, 58, 169, 82, 115, 26, 59, 179,
    63, 59, 90, 180, 59, 166, 93, 73, 154,
    40, 40, 21, 116, 143, 209, 34, 39, 175,
    47, 15, 16, 183, 34, 223, 49, 45, 183,
    46, 17, 33, 183, 6, 98, 15, 32, 183,
    57, 46, 22, 24, 128, 1, 54, 17, 37,
    65, 32, 73, 115, 28, 128, 23, 128, 205,
    40, 3, 9, 115, 51, 192, 18, 6, 223,
    87, 37, 9, 115, 59, 77, 64, 21, 47,
    104, 55, 44, 218, 9, 54, 53, 130, 226,
    64, 90, 70, 205, 40, 41, 23, 26, 57,
    54, 57, 112, 184, 5, 41, 38, 166, 213,
    30, 34, 26, 133, 152, 116, 10, 32, 134,
    39, 19, 53, 221, 26, 114, 32, 73, 255,
    31, 9, 65, 234, 2, 15, 1, 118, 73,
    75, 32, 12, 51, 192, 255, 160, 43, 51,
    88, 31, 35, 67, 102, 85, 55, 186, 85,
    56, 21, 23, 111, 59, 205, 45, 37, 192,
    55, 38, 70, 124, 73, 102, 1, 34, 98,
    125, 98, 42, 88, 104, 85, 117, 175, 82,
    95, 84, 53, 89, 128, 100, 113, 101, 45,
    75, 79, 123, 47, 51, 128, 81, 171, 1,
    57, 17, 5, 71, 102, 57, 53, 41, 49,
    38, 33, 13, 121, 57, 73, 26, 1, 85,
    41, 10, 67, 138, 77, 110, 90, 47, 114,
    115, 21, 2, 10, 102, 255, 166, 23, 6,
    101, 29, 16, 10, 85, 128, 101, 196, 26,
    57, 18, 10, 102, 102, 213, 34, 20, 43,
    117, 20, 15, 36, 163, 128, 68, 1, 26,
    102, 61, 71, 37, 34, 53, 31, 243, 192,
    69, 60, 71, 38, 73, 119, 28, 222, 37,
    68, 45, 128, 34, 1, 47, 11, 245, 171,
    62, 17, 19, 70, 146, 85, 55, 62, 70,
    37, 43, 37, 154, 100, 163, 85, 160, 1,
    63, 9, 92, 136, 28, 64, 32, 201, 85,
    75, 15, 9, 9, 64, 255, 184, 119, 16,
    86, 6, 28, 5, 64, 255, 25, 248, 1,
    56, 8, 17, 132, 137, 255, 55, 116, 128,
    58, 15, 20, 82, 135, 57, 26, 121, 40,
    164, 50, 31, 137, 154, 133, 25, 35, 218,
    51, 103, 44, 131, 131, 123, 31, 6, 158,
    86, 40, 64, 135, 148, 224, 45, 183, 128,
    22, 26, 17, 131, 240, 154, 14, 1, 209,
    45, 16, 21, 91, 64, 222, 7, 1, 197,
    56, 21, 39, 155, 60, 138, 23, 102, 213,
    83, 12, 13, 54, 192, 255, 68, 47, 28,
    85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246,
    35, 27, 10, 146, 174, 171, 12, 26, 128,
    190, 80, 35, 99, 180, 80, 126, 54, 45,
    85, 126, 47, 87, 176, 51, 41, 20, 32,
    101, 75, 128, 139, 118, 146, 116, 128, 85,
    56, 41, 15, 176, 236, 85, 37, 9, 62,
    71, 30, 17, 119, 118, 255, 17, 18, 138,
    101, 38, 60, 138, 55, 70, 43, 26, 142,
    146, 36, 19, 30, 171, 255, 97, 27, 20,
    138, 45, 61, 62, 219, 1, 81, 188, 64,
    32, 41, 20, 117, 151, 142, 20, 21, 163,
    112, 19, 12, 61, 195, 128, 48, 4, 24,
};

constexpr uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
};

constexpr uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
};

constexpr uint8_t kCodeToPlane[120] = {
    24, 7, 23, 25, 40, 6, 39, 41, 22, 26, 38, 42,
    56, 5, 55, 57, 21, 27, 54, 58, 37, 43, 72, 4,
    71, 73, 20, 28, 53, 59, 70, 74, 36, 44, 88, 69,
    75, 52, 60, 3, 87, 89, 19, 29, 86, 90, 35, 45,
    68, 76, 85, 91, 51, 61, 104, 2, 103, 105, 18, 30,
    102, 106, 34, 46, 84, 92, 67, 77, 101, 107, 50, 62,
    120, 1, 119, 121, 83, 93, 17, 31, 100, 108, 66, 78,
    118, 122, 33, 47, 117, 123, 49, 63, 99, 109, 82, 94,
    0, 116, 124, 65, 79, 16, 32, 98, 110, 48, 115, 125,
    81, 95, 64, 114, 126, 97, 111, 80, 113, 127, 96, 112,
};

// ------------------------------------------------------------- lossless

// LSB-first bit reader; reading past the end gives zeros and marks it
struct LBits {
  const uint8_t* b;
  int64_t n;
  int64_t pos = 0;  // in bits
  uint32_t read(int k) {
    uint32_t v = 0;
    for (int i = 0; i < k; ++i, ++pos) {
      const int64_t byte = pos >> 3;
      if (byte < n) v |= uint32_t((b[byte] >> (pos & 7)) & 1) << i;
    }
    return v;
  }
  bool overrun() const { return pos > n * 8; }
};

// A canonical prefix code, decoded bit by bit (first bit read = the code's
// top bit); a single used symbol takes no bits
struct Prefix {
  int single = -1;
  std::vector<int> count, first_symbol;  // per length
  std::vector<int> sorted;
  int max_len = 0;
  // false for an incomplete or empty code
  bool build(const std::vector<int>& lengths) {
    const int n = int(lengths.size());
    count.assign(16, 0);
    int used = 0, last = -1;
    for (int s = 0; s < n; ++s)
      if (lengths[s]) {
        if (lengths[s] > 15) return false;
        ++count[lengths[s]];
        ++used;
        last = s;
      }
    if (used == 0) return false;
    if (used == 1) {
      single = last;
      return true;
    }
    // complete?
    int64_t left = 1;
    for (int l = 1; l < 16; ++l) {
      left = (left << 1) - count[l];
      if (left < 0) return false;
    }
    if (left != 0) return false;
    first_symbol.assign(16, 0);
    int k = 0;
    for (int l = 1; l < 16; ++l) {
      first_symbol[l] = k;
      k += count[l];
      if (count[l]) max_len = l;
    }
    sorted.assign(used, 0);
    std::vector<int> at(first_symbol);
    for (int s = 0; s < n; ++s)
      if (lengths[s]) sorted[at[lengths[s]]++] = s;
    return true;
  }
  int read(LBits& br) const {
    if (single >= 0) return single;
    int code = 0, first = 0;
    for (int l = 1; l <= max_len; ++l) {
      code |= int(br.read(1));
      const int c = count[l];
      if (code - first < c) return sorted[first_symbol[l] + code - first];
      first = (first + c) << 1;
      code <<= 1;
    }
    return 0;  // unreachable for a complete code
  }
};

constexpr int kCodeLengthOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13,
                                      14, 15};

bool read_prefix_code(LBits& br, int alphabet, Prefix* code) {
  std::vector<int> lengths(alphabet, 0);
  if (br.read(1)) {  // simple code
    const int num = int(br.read(1)) + 1;
    const int first = int(br.read(br.read(1) ? 8 : 1));
    if (first >= alphabet) return false;
    lengths[first] = 1;
    if (num == 2) {
      const int second = int(br.read(8));
      if (second >= alphabet) return false;
      lengths[second] = 1;
    }
    return code->build(lengths);
  }
  std::vector<int> cl_lengths(19, 0);
  const int num_codes = int(br.read(4)) + 4;
  for (int i = 0; i < num_codes; ++i) cl_lengths[kCodeLengthOrder[i]] = int(br.read(3));
  Prefix cl;
  if (!cl.build(cl_lengths)) return false;
  int max_symbol = alphabet;
  if (br.read(1)) {
    const int nbits = 2 + 2 * int(br.read(3));
    max_symbol = 2 + int(br.read(nbits));
    if (max_symbol > alphabet) return false;
  }
  int symbol = 0, prev = 8;
  while (symbol < alphabet) {
    if (max_symbol-- == 0) break;
    const int len = cl.read(br);
    if (br.overrun()) return false;
    if (len < 16) {
      lengths[symbol++] = len;
      if (len) prev = len;
    } else {
      const int slot = len - 16;
      const int extra[3] = {2, 3, 7}, offset[3] = {3, 3, 11};
      const int repeat = int(br.read(extra[slot])) + offset[slot];
      if (symbol + repeat > alphabet) return false;
      const int value = len == 16 ? prev : 0;
      for (int r = 0; r < repeat; ++r) lengths[symbol++] = value;
    }
  }
  return code->build(lengths);
}

struct Group {
  Prefix code[5];  // green + lengths + cache, red, blue, alpha, distance
};

inline uint32_t sub_sample(uint32_t size, int bits) { return (size + (1u << bits) - 1) >> bits; }

int copy_distance(int symbol, LBits& br) {
  if (symbol < 4) return symbol + 1;
  const int extra = (symbol - 2) >> 1;
  const int offset = (2 + (symbol & 1)) << extra;
  return offset + int(br.read(extra)) + 1;
}

int plane_to_distance(int xsize, int code) {
  if (code > 120) return code - 120;
  const int dist_code = kCodeToPlane[code - 1];
  const int dist = (dist_code >> 4) * xsize + 8 - (dist_code & 0xf);
  return dist >= 1 ? dist : 1;
}

struct Transform {
  int type, bits, xsize, ysize;
  std::vector<uint32_t> data;
};

int decode_image_stream(LBits& br, int xsize, int ysize, bool level0, std::vector<uint32_t>* out,
                        std::vector<Transform>* transforms);

// the entropy-coded pixels of one image (DecodeImageData)
int decode_pixels(LBits& br, int xsize, int ysize, int cache_bits, bool level0,
                  std::vector<uint32_t>* out) {
  int huff_bits = 0, huff_xsize = 0;
  std::vector<uint32_t> huff_image;
  int num_groups = 1;
  if (level0 && br.read(1)) {
    huff_bits = int(br.read(3)) + 2;
    huff_xsize = int(sub_sample(xsize, huff_bits));
    const int err = decode_image_stream(br, huff_xsize, int(sub_sample(ysize, huff_bits)), false,
                                        &huff_image, nullptr);
    if (err) return err;
    for (uint32_t& v : huff_image) {
      v = (v >> 8) & 0xffff;
      num_groups = std::max(num_groups, int(v) + 1);
    }
  }
  if (br.overrun()) return kTruncated;
  const int cache_size = cache_bits ? 1 << cache_bits : 0;
  std::vector<Group> groups(num_groups);
  const int alphabet[5] = {256 + 24 + cache_size, 256, 256, 256, 40};
  for (Group& g : groups)
    for (int i = 0; i < 5; ++i) {
      if (!read_prefix_code(br, alphabet[i], &g.code[i]))
        return br.overrun() ? kTruncated : kCorrupt;
    }
  std::vector<uint32_t> cache(cache_size, 0);
  const int shift = 32 - cache_bits;
  out->assign(int64_t(xsize) * ysize, 0);
  uint32_t* px = out->data();
  const int64_t total = int64_t(xsize) * ysize;
  int64_t i = 0, cached = 0;
  auto insert_upto = [&](int64_t end) {
    if (!cache_size) return;
    for (; cached < end; ++cached) cache[(0x1e35a7bdu * px[cached]) >> shift] = px[cached];
  };
  while (i < total) {
    const int x = int(i % xsize), y = int(i / xsize);
    const Group& g = groups[huff_bits ? huff_image[(y >> huff_bits) * huff_xsize + (x >> huff_bits)]
                                      : 0];
    const int code = g.code[0].read(br);
    if (code < 256) {
      const uint32_t red = uint32_t(g.code[1].read(br));
      const uint32_t blue = uint32_t(g.code[2].read(br));
      const uint32_t alpha = uint32_t(g.code[3].read(br));
      px[i++] = (alpha << 24) | (red << 16) | (uint32_t(code) << 8) | blue;
    } else if (code < 256 + 24) {
      const int length = copy_distance(code - 256, br);
      const int dist_symbol = g.code[4].read(br);
      const int dist = plane_to_distance(xsize, copy_distance(dist_symbol, br));
      if (br.overrun()) return kTruncated;
      if (i < dist || total - i < length) return kCorrupt;
      for (int k = 0; k < length; ++k, ++i) px[i] = px[i - dist];
    } else {
      const int key = code - 280;
      if (key >= cache_size) return kCorrupt;
      insert_upto(i);
      px[i++] = cache[key];
    }
    if (br.overrun()) return kTruncated;
    insert_upto(i);
  }
  return kOk;
}

int decode_image_stream(LBits& br, int xsize, int ysize, bool level0, std::vector<uint32_t>* out,
                        std::vector<Transform>* transforms) {
  int tx = xsize;
  if (level0) {
    unsigned seen = 0;
    while (br.read(1)) {
      Transform t;
      t.type = int(br.read(2));
      if (seen & (1u << t.type)) return kCorrupt;
      seen |= 1u << t.type;
      t.xsize = tx;
      t.ysize = ysize;
      t.bits = 0;
      if (t.type == 0 || t.type == 1) {
        t.bits = int(br.read(3)) + 2;
        const int err = decode_image_stream(br, int(sub_sample(tx, t.bits)),
                                            int(sub_sample(ysize, t.bits)), false, &t.data,
                                            nullptr);
        if (err) return err;
      } else if (t.type == 3) {
        const int num_colors = int(br.read(8)) + 1;
        t.bits = num_colors > 16 ? 0 : num_colors > 4 ? 1 : num_colors > 2 ? 2 : 3;
        std::vector<uint32_t> pal;
        const int err = decode_image_stream(br, num_colors, 1, false, &pal, nullptr);
        if (err) return err;
        // delta-coded entries, zero-padded to the packing's full range
        t.data.assign(size_t(1) << (8 >> t.bits), 0);
        uint8_t* d = reinterpret_cast<uint8_t*>(t.data.data());
        const uint8_t* s = reinterpret_cast<const uint8_t*>(pal.data());
        for (int k = 0; k < 4 * num_colors; ++k) d[k] = uint8_t(s[k] + (k >= 4 ? d[k - 4] : 0));
        tx = int(sub_sample(tx, t.bits));
      }
      transforms->push_back(std::move(t));
      if (br.overrun()) return kTruncated;
    }
  }
  int cache_bits = 0;
  if (br.read(1)) {
    cache_bits = int(br.read(4));
    if (cache_bits < 1 || cache_bits > 11) return kCorrupt;
  }
  return decode_pixels(br, tx, ysize, cache_bits, level0, out);
}

inline uint32_t average2(uint32_t a, uint32_t b) {
  return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
}

inline uint32_t add_pixels(uint32_t a, uint32_t b) {
  const uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
  const uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
  return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}

inline int clip255(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }

inline int sub3(int a, int b, int c) { return std::abs(b - c) - std::abs(a - c); }

inline uint32_t select_pred(uint32_t a, uint32_t b, uint32_t c) {
  int d = 0;
  for (int s = 0; s < 32; s += 8)
    d += sub3(int((a >> s) & 0xff), int((b >> s) & 0xff), int((c >> s) & 0xff));
  return d <= 0 ? a : b;
}

inline uint32_t clamp_add_sub_full(uint32_t c0, uint32_t c1, uint32_t c2) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8)
    out |= uint32_t(clip255(int((c0 >> s) & 0xff) + int((c1 >> s) & 0xff) -
                            int((c2 >> s) & 0xff))) << s;
  return out;
}

inline uint32_t clamp_add_sub_half(uint32_t c0, uint32_t c1, uint32_t c2) {
  const uint32_t ave = average2(c0, c1);
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    const int a = int((ave >> s) & 0xff), b = int((c2 >> s) & 0xff);
    out |= uint32_t(clip255(a + (a - b) / 2)) << s;
  }
  return out;
}

// the prediction of pixel i (not on the first row or column, except modes
// 0 and 1 and 2 there) from its decoded neighbours; each mode reads only
// the neighbours it uses
uint32_t predict(int mode, const uint32_t* out, int64_t i, int width) {
  const uint32_t* top = out + i - width;
  switch (mode) {
    case 1: return out[i - 1];
    case 2: return top[0];
    case 3: return top[1];
    case 4: return top[-1];
    case 5: return average2(average2(out[i - 1], top[1]), top[0]);
    case 6: return average2(out[i - 1], top[-1]);
    case 7: return average2(out[i - 1], top[0]);
    case 8: return average2(top[-1], top[0]);
    case 9: return average2(top[0], top[1]);
    case 10: return average2(average2(out[i - 1], top[-1]), average2(top[0], top[1]));
    case 11: return select_pred(top[0], out[i - 1], top[-1]);
    case 12: return clamp_add_sub_full(out[i - 1], top[0], top[-1]);
    case 13: return clamp_add_sub_half(out[i - 1], top[0], top[-1]);
    default: return 0xff000000u;
  }
}

inline int color_delta(int8_t pred, int8_t color) { return (int(pred) * color) >> 5; }

// the inverse of one transform on the image `px` (its input size: a
// colour-indexed image is the packed width wide) into *dst
void inverse_transform(const Transform& t, const std::vector<uint32_t>& px,
                       std::vector<uint32_t>* dst) {
  const int w = t.xsize, h = t.ysize;
  dst->assign(int64_t(w) * h, 0);
  uint32_t* out = dst->data();
  if (t.type == 0) {  // predictor
    const int tiles = int(sub_sample(w, t.bits));
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x) {
        const int64_t i = int64_t(y) * w + x;
        int mode;
        if (y == 0) mode = x == 0 ? 0 : 1;
        else if (x == 0) mode = 2;
        else mode = int((t.data[(y >> t.bits) * tiles + (x >> t.bits)] >> 8) & 0xf);
        out[i] = add_pixels(px[i], predict(mode, out, i, w));
      }
  } else if (t.type == 1) {  // cross colour
    const int tiles = int(sub_sample(w, t.bits));
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x) {
        const int64_t i = int64_t(y) * w + x;
        const uint32_t m = t.data[(y >> t.bits) * tiles + (x >> t.bits)];
        const uint32_t argb = px[i];
        const int8_t green = int8_t(argb >> 8);
        int red = int((argb >> 16) & 0xff), blue = int(argb & 0xff);
        red = (red + color_delta(int8_t(m & 0xff), green)) & 0xff;
        blue += color_delta(int8_t((m >> 8) & 0xff), green);
        blue = (blue + color_delta(int8_t((m >> 16) & 0xff), int8_t(red))) & 0xff;
        out[i] = (argb & 0xff00ff00u) | (uint32_t(red) << 16) | uint32_t(blue);
      }
  } else if (t.type == 2) {  // add green
    for (int64_t i = 0; i < int64_t(w) * h; ++i) {
      const uint32_t argb = px[i], green = (argb >> 8) & 0xff;
      const uint32_t red_blue = (argb & 0x00ff00ffu) + ((green << 16) | green);
      out[i] = (argb & 0xff00ff00u) | (red_blue & 0x00ff00ffu);
    }
  } else {  // colour indexing
    const int packed_w = int(sub_sample(w, t.bits));
    const int bpp = 8 >> t.bits, per = 1 << t.bits;
    const uint32_t mask = (1u << bpp) - 1;
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x) {
        const uint32_t packed = (px[int64_t(y) * packed_w + (x >> t.bits)] >> 8) & 0xff;
        const uint32_t index = (packed >> (bpp * (x & (per - 1)))) & mask;
        out[int64_t(y) * w + x] = t.data[index];
      }
  }
}

// a whole VP8L image: the header (headerless for an ALPH stream, whose
// size is given) and the level-0 stream with its transforms undone
int vp8l_decode(const uint8_t* data, int64_t n, int width, int height, bool headerless,
                std::vector<uint32_t>* argb) {
  LBits br{data, n};
  if (!headerless) {
    if (br.read(8) != 0x2f) return kCorrupt;
    const int w = int(br.read(14)) + 1, h = int(br.read(14)) + 1;
    br.read(1);
    if (br.read(3) != 0) return kUnsupported;
    if (w != width || h != height) return kCorrupt;
  }
  std::vector<Transform> transforms;
  std::vector<uint32_t> px;
  int err = decode_image_stream(br, width, height, true, &px, &transforms);
  if (err) return err;
  if (br.overrun()) return kTruncated;
  for (auto t = transforms.rbegin(); t != transforms.rend(); ++t) {
    std::vector<uint32_t> next;
    inverse_transform(*t, px, &next);
    px.swap(next);
  }
  if (int64_t(px.size()) != int64_t(width) * height) return kCorrupt;
  argb->swap(px);
  return kOk;
}

// ---------------------------------------------------------------- lossy

// RFC 6386's boolean decoder (equal, bit for bit, to libwebp's VP8GetBit);
// past the end it reads zeros
struct BoolDecoder {
  const uint8_t* p = nullptr;
  const uint8_t* end = nullptr;
  uint32_t value = 0;
  uint32_t range = 255;
  int bit_count = 0;
  void init(const uint8_t* b, int64_t n) {
    p = b;
    end = b + n;
    value = (next() << 8) | next();
    range = 255;
    bit_count = 0;
  }
  uint32_t next() { return p < end ? *p++ : 0; }
  int get(int prob) {
    const uint32_t split = 1 + (((range - 1) * uint32_t(prob)) >> 8);
    const uint32_t big = split << 8;
    int bit;
    if (value >= big) {
      range -= split;
      value -= big;
      bit = 1;
    } else {
      range = split;
      bit = 0;
    }
    while (range < 128) {
      value <<= 1;
      range <<= 1;
      if (++bit_count == 8) {
        bit_count = 0;
        value |= next();
      }
    }
    return bit;
  }
  int literal(int n) {
    int v = 0;
    while (n--) v = (v << 1) | get(128);
    return v;
  }
  int signed_literal(int n) {
    const int v = literal(n);
    return get(128) ? -v : v;
  }
};

constexpr int kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
constexpr int kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
constexpr uint8_t kCat3[] = {173, 148, 140, 0};
constexpr uint8_t kCat4[] = {176, 155, 140, 135, 0};
constexpr uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
constexpr uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
constexpr const uint8_t* kCat3456[] = {kCat3, kCat4, kCat5, kCat6};
// the intra 4x4 mode tree, modes in libwebp's order: DC, TM, VE, HE, RD, VR,
// LD, VL, HD, HU
constexpr int kYModesIntra4[18] = {-0, 1, -1, 2, -2, 3, 4, 6, -3, 5, -4, -5, -6, 7, -7, 8, -8, -9};
enum { B_DC = 0, B_TM = 1, B_VE = 2, B_HE = 3, B_RD = 4, B_VR = 5, B_LD = 6, B_VL = 7, B_HD = 8,
       B_HU = 9 };

int large_value(BoolDecoder& br, const uint8_t* p) {
  int v;
  if (!br.get(p[3])) {
    v = !br.get(p[4]) ? 2 : 3 + br.get(p[5]);
  } else if (!br.get(p[6])) {
    if (!br.get(p[7])) {
      v = 5 + br.get(159);
    } else {
      v = 7 + 2 * br.get(165);
      v += br.get(145);
    }
  } else {
    const int bit1 = br.get(p[8]);
    const int bit0 = br.get(p[9 + bit1]);
    const int cat = 2 * bit1 + bit0;
    v = 0;
    for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + br.get(*tab);
    v += 3 + (8 << cat);
  }
  return v;
}

struct Proba {
  uint8_t p[4][8][3][11];
};

// GetCoeffs: the tokens of one 4x4 block from position n, dequantised
// (dq[0] for position 0, dq[1] after) into out (natural order); returns
// the position after the last non-zero coefficient (n when none)
int get_coeffs(BoolDecoder& br, const Proba& pr, int type, int ctx, const int* dq, int n,
               int* out) {
  const uint8_t* p = pr.p[type][kBands[n]][ctx];
  for (; n < 16; ++n) {
    if (!br.get(p[0])) return n;
    while (!br.get(p[1])) {
      p = pr.p[type][kBands[++n]][0];
      if (n == 16) return 16;
    }
    int v;
    if (!br.get(p[2])) {
      v = 1;
      p = pr.p[type][kBands[n + 1]][1];
    } else {
      v = large_value(br, p);
      p = pr.p[type][kBands[n + 1]][2];
    }
    out[kZigzag[n]] = (br.get(128) ? -v : v) * dq[n > 0];
  }
  return 16;
}

inline uint8_t clip8(int v) { return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v); }

// TransformOne: the inverse DCT of in (natural order) added to dst
void idct_add(const int* in, uint8_t* dst, int stride) {
  int tmp[16];
  auto mul1 = [](int a) { return ((a * 20091) >> 16) + a; };
  auto mul2 = [](int a) { return (a * 35468) >> 16; };
  for (int i = 0; i < 4; ++i) {
    const int a = in[i] + in[8 + i];
    const int b = in[i] - in[8 + i];
    const int c = mul2(in[4 + i]) - mul1(in[12 + i]);
    const int d = mul1(in[4 + i]) + mul2(in[12 + i]);
    tmp[4 * i + 0] = a + d;
    tmp[4 * i + 1] = b + c;
    tmp[4 * i + 2] = b - c;
    tmp[4 * i + 3] = a - d;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[i] + 4;
    const int a = dc + tmp[8 + i];
    const int b = dc - tmp[8 + i];
    const int c = mul2(tmp[4 + i]) - mul1(tmp[12 + i]);
    const int d = mul1(tmp[4 + i]) + mul2(tmp[12 + i]);
    uint8_t* row = dst + i * stride;
    row[0] = clip8(row[0] + ((a + d) >> 3));
    row[1] = clip8(row[1] + ((b + c) >> 3));
    row[2] = clip8(row[2] + ((b - c) >> 3));
    row[3] = clip8(row[3] + ((a - d) >> 3));
  }
}

// TransformWHT: the Y2 block into the DC of the 16 luma blocks
void iwht(const int* in, int* out /* 16 blocks x 16 */) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i];
    const int a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i];
    const int a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4];
    const int a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
    const int a3 = dc - tmp[3 + i * 4];
    out[(4 * i + 0) * 16] = (a0 + a1) >> 3;
    out[(4 * i + 1) * 16] = (a3 + a2) >> 3;
    out[(4 * i + 2) * 16] = (a0 - a1) >> 3;
    out[(4 * i + 3) * 16] = (a3 - a2) >> 3;
  }
}

// --- intra prediction on a work buffer (row stride S), dst at the block's
// top-left; dst[-S] the row above, dst[-1] the column to the left
constexpr int S = 32;

inline uint8_t avg3(int a, int b, int c) { return uint8_t((a + 2 * b + c + 2) >> 2); }
inline uint8_t avg2(int a, int b) { return uint8_t((a + b + 1) >> 1); }

void true_motion(uint8_t* dst, int size) {
  const uint8_t* top = dst - S;
  const int tl = top[-1];
  for (int y = 0; y < size; ++y) {
    const int l = dst[y * S - 1];
    for (int x = 0; x < size; ++x) dst[y * S + x] = clip8(top[x] + l - tl);
  }
}

void fill(uint8_t* dst, int size, int v) {
  for (int y = 0; y < size; ++y) std::memset(dst + y * S, v, size);
}

// 16x16 luma (size 16) or 8x8 chroma (size 8): mode DC, TM, VE, HE with
// libwebp's DC variants where the top row or left column is missing
void predict_block(uint8_t* dst, int size, int mode, bool has_top, bool has_left) {
  const int shift = size == 16 ? 4 : 3;
  if (mode == B_DC) {
    int dc;
    if (has_top && has_left) {
      dc = size;
      for (int j = 0; j < size; ++j) dc += dst[j * S - 1] + dst[j - S];
      dc >>= shift + 1;
    } else if (has_left) {
      dc = size >> 1;
      for (int j = 0; j < size; ++j) dc += dst[j * S - 1];
      dc >>= shift;
    } else if (has_top) {
      dc = size >> 1;
      for (int j = 0; j < size; ++j) dc += dst[j - S];
      dc >>= shift;
    } else {
      dc = 0x80;
    }
    fill(dst, size, dc);
  } else if (mode == B_TM) {
    true_motion(dst, size);
  } else if (mode == B_VE) {
    for (int y = 0; y < size; ++y) std::memcpy(dst + y * S, dst - S, size);
  } else {
    for (int y = 0; y < size; ++y) std::memset(dst + y * S, dst[y * S - 1], size);
  }
}

#define DST(x, y) dst[(x) + (y) * S]

void predict4(uint8_t* dst, int mode) {
  const uint8_t* top = dst - S;
  const int X = top[-1], A = top[0], B = top[1], C = top[2], D = top[3], E = top[4], F = top[5],
            G = top[6], H = top[7];
  const int I = dst[-1], J = dst[S - 1], K = dst[2 * S - 1], L = dst[3 * S - 1];
  switch (mode) {
    case B_DC: {
      int dc = 4;
      for (int i = 0; i < 4; ++i) dc += top[i] + dst[i * S - 1];
      fill(dst, 4, dc >> 3);
      break;
    }
    case B_TM: true_motion(dst, 4); break;
    case B_VE: {
      const uint8_t v[4] = {avg3(X, A, B), avg3(A, B, C), avg3(B, C, D), avg3(C, D, E)};
      for (int y = 0; y < 4; ++y) std::memcpy(dst + y * S, v, 4);
      break;
    }
    case B_HE: {
      const uint8_t v[4] = {avg3(X, I, J), avg3(I, J, K), avg3(J, K, L), avg3(K, L, L)};
      for (int y = 0; y < 4; ++y) std::memset(dst + y * S, v[y], 4);
      break;
    }
    case B_RD:
      DST(0, 3) = avg3(J, K, L);
      DST(1, 3) = DST(0, 2) = avg3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
      DST(3, 1) = DST(2, 0) = avg3(C, B, A);
      DST(3, 0) = avg3(D, C, B);
      break;
    case B_LD:
      DST(0, 0) = avg3(A, B, C);
      DST(1, 0) = DST(0, 1) = avg3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
      DST(3, 2) = DST(2, 3) = avg3(F, G, H);
      DST(3, 3) = avg3(G, H, H);
      break;
    case B_VR:
      DST(0, 0) = DST(1, 2) = avg2(X, A);
      DST(1, 0) = DST(2, 2) = avg2(A, B);
      DST(2, 0) = DST(3, 2) = avg2(B, C);
      DST(3, 0) = avg2(C, D);
      DST(0, 3) = avg3(K, J, I);
      DST(0, 2) = avg3(J, I, X);
      DST(0, 1) = DST(1, 3) = avg3(I, X, A);
      DST(1, 1) = DST(2, 3) = avg3(X, A, B);
      DST(2, 1) = DST(3, 3) = avg3(A, B, C);
      DST(3, 1) = avg3(B, C, D);
      break;
    case B_VL:
      DST(0, 0) = avg2(A, B);
      DST(1, 0) = DST(0, 2) = avg2(B, C);
      DST(2, 0) = DST(1, 2) = avg2(C, D);
      DST(3, 0) = DST(2, 2) = avg2(D, E);
      DST(0, 1) = avg3(A, B, C);
      DST(1, 1) = DST(0, 3) = avg3(B, C, D);
      DST(2, 1) = DST(1, 3) = avg3(C, D, E);
      DST(3, 1) = DST(2, 3) = avg3(D, E, F);
      DST(3, 2) = avg3(E, F, G);
      DST(3, 3) = avg3(F, G, H);
      break;
    case B_HU:
      DST(0, 0) = avg2(I, J);
      DST(2, 0) = DST(0, 1) = avg2(J, K);
      DST(2, 1) = DST(0, 2) = avg2(K, L);
      DST(1, 0) = avg3(I, J, K);
      DST(3, 0) = DST(1, 1) = avg3(J, K, L);
      DST(3, 1) = DST(1, 2) = avg3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = uint8_t(L);
      break;
    default:  // B_HD
      DST(0, 0) = DST(2, 1) = avg2(I, X);
      DST(0, 1) = DST(2, 2) = avg2(J, I);
      DST(0, 2) = DST(2, 3) = avg2(K, J);
      DST(0, 3) = avg2(L, K);
      DST(3, 0) = avg3(A, B, C);
      DST(2, 0) = avg3(X, A, B);
      DST(1, 0) = DST(3, 1) = avg3(I, X, A);
      DST(1, 1) = DST(3, 2) = avg3(J, I, X);
      DST(1, 2) = DST(3, 3) = avg3(K, J, I);
      DST(1, 3) = avg3(L, K, J);
      break;
  }
}

#undef DST

// --- loop filter (dsp/dec.c), p at the first pixel past the edge, `step`
// across it
inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }

inline void filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
}

inline void filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = clip8(p1 + a3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a3);
}

inline void filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7;
  const int a2 = (18 * a + 63) >> 7;
  const int a3 = (9 * a + 63) >> 7;
  p[-3 * step] = clip8(p2 + a3);
  p[-2 * step] = clip8(p1 + a2);
  p[-step] = clip8(p0 + a1);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a2);
  p[2 * step] = clip8(q2 - a3);
}

inline bool hev(const uint8_t* p, int step, int thresh) {
  return std::abs(p[-2 * step] - p[-step]) > thresh || std::abs(p[step] - p[0]) > thresh;
}

inline bool needs_filter(const uint8_t* p, int step, int t) {
  return 4 * std::abs(p[-step] - p[0]) + std::abs(p[-2 * step] - p[step]) <= t;
}

inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
  return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it && std::abs(p1 - p0) <= it &&
         std::abs(q3 - q2) <= it && std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}

// `size` pixels along an edge, each `vstride` apart, filtered across by
// `hstride`; six taps on macroblock edges, four inside
void filter_loop(uint8_t* p, int hstride, int vstride, int size, int thresh, int ithresh,
                 int hev_t, bool mb_edge) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < size; ++i, p += vstride) {
    if (!needs_filter2(p, hstride, t2, ithresh)) continue;
    if (hev(p, hstride, hev_t)) filter2(p, hstride);
    else if (mb_edge) filter6(p, hstride);
    else filter4(p, hstride);
  }
}

void simple_filter(uint8_t* p, int hstride, int vstride, int thresh) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i, p += vstride)
    if (needs_filter(p, hstride, t2)) filter2(p, hstride);
}

struct MB {
  int segment = 0, i4x4 = 0, ymode = 0, uvmode = 0, skip = 0;
  int imodes[16];
  int coeffs[25 * 16];  // 16 Y, 4 U, 4 V, then Y2 (unused after the WHT)
  bool nonzero = false;
};

struct FInfo {
  int limit = 0, ilevel = 0, hev = 0;
};

// One VP8 key frame -> RGB (fancy upsampling), width x height; libwebp's
// VP8GetHeaders, ParseIntraMode, ParseResiduals, ReconstructRow, DoFilter
// and EmitFancyRGB
int vp8_decode(const uint8_t* data, int64_t n, int width, int height, uint8_t* rgb) {
  if (n < 10) return kTruncated;
  const uint32_t bits = data[0] | (data[1] << 8) | (data[2] << 16);
  if (bits & 1) return kUnsupported;  // not a key frame
  if (((bits >> 1) & 7) > 3 || !((bits >> 4) & 1)) return kCorrupt;
  const int64_t part0 = bits >> 5;
  if (data[3] != 0x9d || data[4] != 0x01 || data[5] != 0x2a) return kCorrupt;
  const int w = ((data[7] << 8) | data[6]) & 0x3fff, h = ((data[9] << 8) | data[8]) & 0x3fff;
  if (w != width || h != height || w == 0 || h == 0) return kCorrupt;
  data += 10;
  n -= 10;
  if (part0 > n) return kTruncated;
  BoolDecoder br;
  br.init(data, part0);
  br.get(128);  // colour space
  br.get(128);  // clamping type
  // segments
  int use_segment = br.get(128), update_map = 0, absolute = 0;
  int quantizer[4] = {0, 0, 0, 0}, fstrength[4] = {0, 0, 0, 0};
  int seg_p[3] = {255, 255, 255};
  if (use_segment) {
    update_map = br.get(128);
    if (br.get(128)) {
      absolute = br.get(128);
      for (int s = 0; s < 4; ++s) quantizer[s] = br.get(128) ? br.signed_literal(7) : 0;
      for (int s = 0; s < 4; ++s) fstrength[s] = br.get(128) ? br.signed_literal(6) : 0;
    }
    if (update_map)
      for (int s = 0; s < 3; ++s) seg_p[s] = br.get(128) ? br.literal(8) : 255;
  }
  // filter header
  const int simple = br.get(128), level = br.literal(6), sharpness = br.literal(3);
  int use_lf_delta = br.get(128), ref_delta0 = 0, mode_delta0 = 0;
  if (use_lf_delta && br.get(128)) {
    for (int i = 0; i < 4; ++i)
      if (br.get(128)) {
        const int v = br.signed_literal(6);
        if (i == 0) ref_delta0 = v;
      }
    for (int i = 0; i < 4; ++i)
      if (br.get(128)) {
        const int v = br.signed_literal(6);
        if (i == 0) mode_delta0 = v;
      }
  }
  const int filter_type = level == 0 ? 0 : simple ? 1 : 2;
  // partitions
  const int nparts = 1 << br.literal(2);
  const uint8_t* buf = data + part0;
  int64_t left = n - part0;
  if (left < 3 * (nparts - 1)) return kTruncated;
  const uint8_t* sz = buf;
  const uint8_t* pstart = buf + 3 * (nparts - 1);
  left -= 3 * (nparts - 1);
  std::vector<BoolDecoder> parts(nparts);
  for (int p = 0; p < nparts - 1; ++p) {
    int64_t psize = sz[0] | (sz[1] << 8) | (sz[2] << 16);
    if (psize > left) psize = left;
    parts[p].init(pstart, psize);
    pstart += psize;
    left -= psize;
    sz += 3;
  }
  parts[nparts - 1].init(pstart, left);
  if (left <= 0) return kTruncated;
  // quantizers
  const int base_q = br.literal(7);
  const int dy1_dc = br.get(128) ? br.signed_literal(4) : 0;
  const int dy2_dc = br.get(128) ? br.signed_literal(4) : 0;
  const int dy2_ac = br.get(128) ? br.signed_literal(4) : 0;
  const int duv_dc = br.get(128) ? br.signed_literal(4) : 0;
  const int duv_ac = br.get(128) ? br.signed_literal(4) : 0;
  int dq[4][3][2];  // segment, (y1, y2, uv), (dc, ac)
  auto clipq = [](int v, int m) { return v < 0 ? 0 : v > m ? m : v; };
  for (int s = 0; s < 4; ++s) {
    int q = base_q;
    if (use_segment) q = quantizer[s] + (absolute ? 0 : base_q);
    dq[s][0][0] = kDcTable[clipq(q + dy1_dc, 127)];
    dq[s][0][1] = kAcTable[clipq(q, 127)];
    dq[s][1][0] = kDcTable[clipq(q + dy2_dc, 127)] * 2;
    dq[s][1][1] = std::max((kAcTable[clipq(q + dy2_ac, 127)] * 101581) >> 16, 8);
    dq[s][2][0] = kDcTable[clipq(q + duv_dc, 117)];
    dq[s][2][1] = kAcTable[clipq(q + duv_ac, 127)];
  }
  br.get(128);  // refresh entropy probabilities
  Proba pr;
  for (int t = 0; t < 4; ++t)
    for (int b = 0; b < 8; ++b)
      for (int c = 0; c < 3; ++c)
        for (int p = 0; p < 11; ++p)
          pr.p[t][b][c][p] = uint8_t(br.get(kCoeffsUpdateProba[t][b][c][p])
                                         ? br.literal(8) : kCoeffsProba0[t][b][c][p]);
  const int use_skip = br.get(128);
  const int skip_p = use_skip ? br.literal(8) : 0;
  // filter strengths per segment and i4x4 (PrecomputeFilterStrengths)
  FInfo fstr[4][2];
  for (int s = 0; s < 4; ++s) {
    int base = level;
    if (use_segment) base = fstrength[s] + (absolute ? 0 : level);
    for (int i4 = 0; i4 < 2; ++i4) {
      int lv = base;
      if (use_lf_delta) {
        lv += ref_delta0;
        if (i4) lv += mode_delta0;
      }
      lv = lv < 0 ? 0 : lv > 63 ? 63 : lv;
      if (lv > 0) {
        int il = lv;
        if (sharpness > 0) {
          il >>= sharpness > 4 ? 2 : 1;
          if (il > 9 - sharpness) il = 9 - sharpness;
        }
        if (il < 1) il = 1;
        fstr[s][i4] = FInfo{2 * lv + il, il, lv >= 40 ? 2 : lv >= 15 ? 1 : 0};
      }
    }
  }
  // macroblocks
  const int mbw = (w + 15) >> 4, mbh = (h + 15) >> 4;
  const int yw = mbw * 16, uvw = mbw * 8;
  std::vector<uint8_t> Y(int64_t(yw) * mbh * 16), U(int64_t(uvw) * mbh * 8), V(U.size());
  std::vector<MB> mbs(mbw);
  std::vector<int> top_modes(mbw * 4, B_DC);
  std::vector<uint8_t> top_nz(mbw * 9, 0);  // 4 Y, 2 U, 2 V, Y2
  std::vector<FInfo> finfo(int64_t(mbw) * mbh);
  std::vector<uint8_t> inner(int64_t(mbw) * mbh);
  uint8_t yb[17 * S], ub[9 * S], vb[9 * S];
  for (int my = 0; my < mbh; ++my) {
    int left_modes[4] = {B_DC, B_DC, B_DC, B_DC};
    uint8_t left_nz[9] = {0};
    BoolDecoder& tb = parts[my & (nparts - 1)];
    for (int mx = 0; mx < mbw; ++mx) {
      MB& mb = mbs[mx];
      // modes (ParseIntraMode)
      mb.segment = update_map ? (!br.get(seg_p[0]) ? br.get(seg_p[1]) : 2 + br.get(seg_p[2])) : 0;
      mb.skip = use_skip ? br.get(skip_p) : 0;
      mb.i4x4 = !br.get(145);
      int* top = &top_modes[mx * 4];
      if (!mb.i4x4) {
        const int ymode = br.get(156) ? (br.get(128) ? B_TM : B_HE) : (br.get(163) ? B_VE : B_DC);
        mb.ymode = ymode;
        for (int i = 0; i < 4; ++i) top[i] = left_modes[i] = ymode;
      } else {
        for (int y = 0; y < 4; ++y) {
          int ymode = left_modes[y];
          for (int x = 0; x < 4; ++x) {
            const uint8_t* prob = kBModesProba[top[x]][ymode];
            int i = kYModesIntra4[br.get(prob[0])];
            while (i > 0) i = kYModesIntra4[2 * i + br.get(prob[i])];
            ymode = -i;
            top[x] = ymode;
            mb.imodes[y * 4 + x] = ymode;
          }
          left_modes[y] = ymode;
        }
      }
      mb.uvmode = !br.get(142) ? B_DC : !br.get(114) ? B_VE : br.get(183) ? B_TM : B_HE;
      // residuals (ParseResiduals)
      std::memset(mb.coeffs, 0, sizeof mb.coeffs);
      uint8_t* tnz = &top_nz[mx * 9];
      const int* q0 = dq[mb.segment][0];
      const int* q2 = dq[mb.segment][2];
      if (!mb.skip) {
        int first = 0, ytype = 3;
        if (!mb.i4x4) {
          int dc[16] = {0};
          const int ctx = tnz[8] + left_nz[8];
          const int nz = get_coeffs(tb, pr, 1, ctx, dq[mb.segment][1], 0, dc);
          tnz[8] = left_nz[8] = nz > 0;
          iwht(dc, mb.coeffs);
          first = 1;
          ytype = 0;
        }
        for (int y = 0; y < 4; ++y)
          for (int x = 0; x < 4; ++x) {
            const int ctx = left_nz[y] + tnz[x];
            const int nz = get_coeffs(tb, pr, ytype, ctx, q0, first, mb.coeffs + (y * 4 + x) * 16);
            tnz[x] = left_nz[y] = nz > first;
          }
        for (int ch = 0; ch < 2; ++ch)
          for (int y = 0; y < 2; ++y)
            for (int x = 0; x < 2; ++x) {
              const int ctx = left_nz[4 + 2 * ch + y] + tnz[4 + 2 * ch + x];
              const int nz = get_coeffs(tb, pr, 2, ctx, q2, 0,
                                        mb.coeffs + (16 + 4 * ch + 2 * y + x) * 16);
              tnz[4 + 2 * ch + x] = left_nz[4 + 2 * ch + y] = nz > 0;
            }
      } else {
        std::memset(tnz, 0, 8);
        std::memset(left_nz, 0, 8);
        if (!mb.i4x4) tnz[8] = left_nz[8] = 0;
      }
      mb.nonzero = false;
      for (int i = 0; i < 24 * 16; ++i) mb.nonzero |= mb.coeffs[i] != 0;
      if (filter_type) {
        finfo[int64_t(my) * mbw + mx] = fstr[mb.segment][mb.i4x4];
        inner[int64_t(my) * mbw + mx] = uint8_t(mb.i4x4 || mb.nonzero);
      }
      // reconstruction (ReconstructRow) on the work buffers: the row above
      // (127 on the top row), the column to the left (129 on the left edge)
      uint8_t* yd = yb + S + 4;
      uint8_t* ud = ub + S + 4;
      uint8_t* vd = vb + S + 4;
      const uint8_t* yrow = &Y[int64_t(my) * 16 * yw + mx * 16];
      const uint8_t* urow = &U[int64_t(my) * 8 * uvw + mx * 8];
      const uint8_t* vrow = &V[int64_t(my) * 8 * uvw + mx * 8];
      if (my == 0) {
        std::memset(yd - S - 1, 127, 21);
        std::memset(ud - S - 1, 127, 9);
        std::memset(vd - S - 1, 127, 9);
      } else {
        std::memcpy(yd - S, yrow - yw, 16);
        std::memcpy(ud - S, urow - uvw, 8);
        std::memcpy(vd - S, vrow - uvw, 8);
        yd[-S - 1] = mx ? yrow[-yw - 1] : 129;
        ud[-S - 1] = mx ? urow[-uvw - 1] : 129;
        vd[-S - 1] = mx ? vrow[-uvw - 1] : 129;
        if (mx == mbw - 1) std::memset(yd - S + 16, yrow[-yw + 15], 4);
        else std::memcpy(yd - S + 16, yrow - yw + 16, 4);
      }
      for (int j = 0; j < 16; ++j) yd[j * S - 1] = mx ? yrow[j * yw - 1] : 129;
      for (int j = 0; j < 8; ++j) {
        ud[j * S - 1] = mx ? urow[j * uvw - 1] : 129;
        vd[j * S - 1] = mx ? vrow[j * uvw - 1] : 129;
      }
      if (mb.i4x4) {
        for (int r = 3; r < 16; r += 4) std::memcpy(yd + r * S + 16, yd - S + 16, 4);
        for (int b = 0; b < 16; ++b) {
          uint8_t* dst = yd + (b >> 2) * 4 * S + (b & 3) * 4;
          predict4(dst, mb.imodes[b]);
          idct_add(mb.coeffs + b * 16, dst, S);
        }
      } else {
        predict_block(yd, 16, mb.ymode, my > 0, mx > 0);
        for (int b = 0; b < 16; ++b)
          idct_add(mb.coeffs + b * 16, yd + (b >> 2) * 4 * S + (b & 3) * 4, S);
      }
      predict_block(ud, 8, mb.uvmode, my > 0, mx > 0);
      predict_block(vd, 8, mb.uvmode, my > 0, mx > 0);
      for (int b = 0; b < 4; ++b) {
        idct_add(mb.coeffs + (16 + b) * 16, ud + (b >> 1) * 4 * S + (b & 1) * 4, S);
        idct_add(mb.coeffs + (20 + b) * 16, vd + (b >> 1) * 4 * S + (b & 1) * 4, S);
      }
      uint8_t* yo = &Y[int64_t(my) * 16 * yw + mx * 16];
      uint8_t* uo = &U[int64_t(my) * 8 * uvw + mx * 8];
      uint8_t* vo = &V[int64_t(my) * 8 * uvw + mx * 8];
      for (int j = 0; j < 16; ++j) std::memcpy(yo + j * yw, yd + j * S, 16);
      for (int j = 0; j < 8; ++j) {
        std::memcpy(uo + j * uvw, ud + j * S, 8);
        std::memcpy(vo + j * uvw, vd + j * S, 8);
      }
    }
  }
  // the loop filter, macroblocks in raster order (DoFilter)
  if (filter_type) {
    for (int my = 0; my < mbh; ++my)
      for (int mx = 0; mx < mbw; ++mx) {
        const FInfo& f = finfo[int64_t(my) * mbw + mx];
        if (f.limit == 0) continue;
        const bool in = inner[int64_t(my) * mbw + mx];
        uint8_t* yp = &Y[int64_t(my) * 16 * yw + mx * 16];
        if (filter_type == 1) {
          if (mx > 0) simple_filter(yp, 1, yw, f.limit + 4);
          if (in)
            for (int k = 4; k < 16; k += 4) simple_filter(yp + k, 1, yw, f.limit);
          if (my > 0) simple_filter(yp, yw, 1, f.limit + 4);
          if (in)
            for (int k = 4; k < 16; k += 4) simple_filter(yp + k * yw, yw, 1, f.limit);
          continue;
        }
        uint8_t* up = &U[int64_t(my) * 8 * uvw + mx * 8];
        uint8_t* vp = &V[int64_t(my) * 8 * uvw + mx * 8];
        if (mx > 0) {
          filter_loop(yp, 1, yw, 16, f.limit + 4, f.ilevel, f.hev, true);
          filter_loop(up, 1, uvw, 8, f.limit + 4, f.ilevel, f.hev, true);
          filter_loop(vp, 1, uvw, 8, f.limit + 4, f.ilevel, f.hev, true);
        }
        if (in) {
          for (int k = 4; k < 16; k += 4)
            filter_loop(yp + k, 1, yw, 16, f.limit, f.ilevel, f.hev, false);
          filter_loop(up + 4, 1, uvw, 8, f.limit, f.ilevel, f.hev, false);
          filter_loop(vp + 4, 1, uvw, 8, f.limit, f.ilevel, f.hev, false);
        }
        if (my > 0) {
          filter_loop(yp, yw, 1, 16, f.limit + 4, f.ilevel, f.hev, true);
          filter_loop(up, uvw, 1, 8, f.limit + 4, f.ilevel, f.hev, true);
          filter_loop(vp, uvw, 1, 8, f.limit + 4, f.ilevel, f.hev, true);
        }
        if (in) {
          for (int k = 4; k < 16; k += 4)
            filter_loop(yp + k * yw, yw, 1, 16, f.limit, f.ilevel, f.hev, false);
          filter_loop(up + 4 * uvw, uvw, 1, 8, f.limit, f.ilevel, f.hev, false);
          filter_loop(vp + 4 * uvw, uvw, 1, 8, f.limit, f.ilevel, f.hev, false);
        }
      }
  }
  // fancy upsampling and YUV -> RGB (EmitFancyRGB, UpsampleRgbLinePair)
  auto mult_hi = [](int v, int c) { return (v * c) >> 8; };
  auto clip_yuv = [](int v) { return (v & ~16383) == 0 ? v >> 6 : v < 0 ? 0 : 255; };
  auto put = [&](int y, int u, int v, uint8_t* o) {
    o[0] = uint8_t(clip_yuv(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234));
    o[1] = uint8_t(clip_yuv(mult_hi(y, 19077) - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708));
    o[2] = uint8_t(clip_yuv(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685));
  };
  auto line_pair = [&](const uint8_t* ty, const uint8_t* by, const uint8_t* tu, const uint8_t* tv,
                       const uint8_t* cu, const uint8_t* cv, uint8_t* tdst, uint8_t* bdst) {
    const int last = (w - 1) >> 1;
    uint32_t tl = tu[0] | (uint32_t(tv[0]) << 16), l = cu[0] | (uint32_t(cv[0]) << 16);
    {
      const uint32_t uv0 = (3 * tl + l + 0x00020002u) >> 2;
      put(ty[0], uv0 & 0xff, uv0 >> 16, tdst);
    }
    if (by) {
      const uint32_t uv0 = (3 * l + tl + 0x00020002u) >> 2;
      put(by[0], uv0 & 0xff, uv0 >> 16, bdst);
    }
    for (int x = 1; x <= last; ++x) {
      const uint32_t t = tu[x] | (uint32_t(tv[x]) << 16), c = cu[x] | (uint32_t(cv[x]) << 16);
      const uint32_t avg = tl + t + l + c + 0x00080008u;
      const uint32_t d12 = (avg + 2 * (t + l)) >> 3;
      const uint32_t d03 = (avg + 2 * (tl + c)) >> 3;
      {
        const uint32_t uv0 = (d12 + tl) >> 1, uv1 = (d03 + t) >> 1;
        put(ty[2 * x - 1], uv0 & 0xff, uv0 >> 16, tdst + (2 * x - 1) * 3);
        put(ty[2 * x], uv1 & 0xff, uv1 >> 16, tdst + 2 * x * 3);
      }
      if (by) {
        const uint32_t uv0 = (d03 + l) >> 1, uv1 = (d12 + c) >> 1;
        put(by[2 * x - 1], uv0 & 0xff, uv0 >> 16, bdst + (2 * x - 1) * 3);
        put(by[2 * x], uv1 & 0xff, uv1 >> 16, bdst + 2 * x * 3);
      }
      tl = t;
      l = c;
    }
    if (!(w & 1)) {
      {
        const uint32_t uv0 = (3 * tl + l + 0x00020002u) >> 2;
        put(ty[w - 1], uv0 & 0xff, uv0 >> 16, tdst + (w - 1) * 3);
      }
      if (by) {
        const uint32_t uv0 = (3 * l + tl + 0x00020002u) >> 2;
        put(by[w - 1], uv0 & 0xff, uv0 >> 16, bdst + (w - 1) * 3);
      }
    }
  };
  const int64_t rs = int64_t(w) * 3;
  // row 0 alone (its chroma row mirrored), then row pairs (y, y + 1) between
  // chroma rows (y - 1) / 2 and (y + 1) / 2, and an even height's last row
  line_pair(&Y[0], nullptr, &U[0], &V[0], &U[0], &V[0], rgb, nullptr);
  int y = 1;
  for (; y + 1 < h; y += 2) {
    const int64_t k = (y + 1) / 2;
    line_pair(&Y[y * int64_t(yw)], &Y[(y + 1) * int64_t(yw)], &U[(k - 1) * uvw],
              &V[(k - 1) * uvw], &U[k * uvw], &V[k * uvw], rgb + y * rs, rgb + (y + 1) * rs);
  }
  if (y < h) {
    const int64_t k = (y - 1) / 2;
    line_pair(&Y[y * int64_t(yw)], nullptr, &U[k * uvw], &V[k * uvw], &U[k * uvw], &V[k * uvw],
              rgb + y * rs, nullptr);
  }
  return kOk;
}

// --------------------------------------------------------------- alpha

// An ALPH chunk's payload -> the alpha plane (ALPHDecode, the unfilters)
int alpha_decode(const uint8_t* data, int64_t n, int width, int height, uint8_t* alpha) {
  if (n < 1) return kTruncated;
  const int method = data[0] & 3, filter = (data[0] >> 2) & 3, pre = (data[0] >> 4) & 3;
  if (method > 1 || pre > 1 || (data[0] >> 6)) return kCorrupt;
  const int64_t total = int64_t(width) * height;
  std::vector<uint8_t> raw(total);
  if (method == 0) {
    if (n - 1 < total) return kTruncated;
    std::memcpy(raw.data(), data + 1, total);
  } else {
    std::vector<uint32_t> argb;
    const int err = vp8l_decode(data + 1, n - 1, width, height, true, &argb);
    if (err) return err;
    for (int64_t i = 0; i < total; ++i) raw[i] = uint8_t(argb[i] >> 8);
  }
  for (int y = 0; y < height; ++y) {
    const uint8_t* in = &raw[int64_t(y) * width];
    uint8_t* out = alpha + int64_t(y) * width;
    const uint8_t* prev = y ? out - width : nullptr;
    if (filter == 0) {
      std::memcpy(out, in, width);
    } else if (filter == 1 || !prev) {  // horizontal, and every filter's first row
      uint8_t pred = prev && filter == 1 ? prev[0] : 0;
      for (int x = 0; x < width; ++x) pred = out[x] = uint8_t(pred + in[x]);
    } else if (filter == 2) {
      for (int x = 0; x < width; ++x) out[x] = uint8_t(prev[x] + in[x]);
    } else {
      int top = prev[0], top_left = top, left = top;
      for (int x = 0; x < width; ++x) {
        top = prev[x];
        left = uint8_t(in[x] + clip8(left + top - top_left));
        top_left = top;
        out[x] = uint8_t(left);
      }
    }
  }
  return kOk;
}

}  // namespace

extern "C" {

// A VP8L bitstream (its 5-byte header included) -> width x height ARGB
// (uint32, 0xAARRGGBB). Returns 0 or an Err.
int webp_lossless_decode(const uint8_t* data, int64_t n, int width, int height, uint32_t* argb) {
  if (width <= 0 || height <= 0) return kBadArgument;
  std::vector<uint32_t> px;
  const int err = vp8l_decode(data, n, width, height, false, &px);
  if (!err) std::memcpy(argb, px.data(), px.size() * 4);
  return err;
}

// A VP8 key frame (from its frame tag) -> width x height x 3 RGB.
int webp_lossy_decode(const uint8_t* data, int64_t n, int width, int height, uint8_t* rgb) {
  if (width <= 0 || height <= 0) return kBadArgument;
  return vp8_decode(data, n, width, height, rgb);
}

// An ALPH chunk's payload -> width x height alpha.
int webp_alpha_decode(const uint8_t* data, int64_t n, int width, int height, uint8_t* alpha) {
  if (width <= 0 || height <= 0) return kBadArgument;
  return alpha_decode(data, n, width, height, alpha);
}

}  // extern "C"

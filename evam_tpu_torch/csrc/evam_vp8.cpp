// The port's VP8 encoder (RFC 6386), in evam_tpu_torch's host library.
//
// The reference encodes VP8 through cv2.VideoWriter (FFmpeg and libvpx
// into a temporary WebM, then an EBML walk). The card's machine has no
// cv2 and no libvpx, so the port carries its own encoder, built into
// the same shared library as csrc/evam_media.cpp (evam_tpu_torch/native.py)
// and called through ctypes with the interpreter lock released.
//
// What it writes (every choice one that a VP8 decoder must accept):
//
// - Keyframes: one DCT partition, loop_filter_level 0 (so no loop
//   filter runs), a fixed q_index, the default coefficient
//   probabilities with no updates, mb_no_coeff_skip on. Luma is
//   predicted 16x16 with DC, V, H or TM, chosen per macroblock by SSE
//   against the source; chroma with the same four modes. Every
//   macroblock carries a Y2 block. Forward transforms are libvpx's
//   vp8_short_fdct4x4_c and vp8_short_walsh4x4_c; the reconstruction
//   runs the decoder's arithmetic (RFC 6386 §14: dequantization, the
//   inverse WHT and IDCT with their 16-bit intermediates, prediction
//   edges of 127 above and 129 left).
// - Inter frames: every macroblock inter-coded against LAST with ZEROMV,
//   its mode coded with the mv_ref probabilities of the contexts that
//   §16.3's find_near_mvs gives when every neighbour's vector is zero;
//   the residual is the source minus the last reconstruction, with Y2;
//   a macroblock whose coefficients all quantize to zero is skipped.
//   Only LAST is refreshed.
//
// The encoder keeps its reconstruction, which a decoder reproduces bit
// for bit (tests/test_torch_rtc.py holds libvpx's decode to it).
// Planes come in and go out as one I420 buffer at the macroblock-aligned
// size; the frame header carries the display size.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

// RFC 6386 §14.1
const int kDcQ[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
};
const int kAcQ[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
};

// RFC 6386 §13.5: default_coeff_probs [block type][band][context][node]
const uint8_t kCoeffProbs[4][8][3][11] = {
    {
        {
            {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
            {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
            {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
        },
        {
            {253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128},
            {189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128},
            {106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128},
        },
        {
            {  1,  98, 248, 255, 236, 226, 255, 255, 128, 128, 128},
            {181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128},
            { 78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128},
        },
        {
            {  1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128},
            {184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128},
            { 77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128},
        },
        {
            {  1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128},
            {170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128},
            { 37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128},
        },
        {
            {  1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128},
            {207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128},
            {102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128},
        },
        {
            {  1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128},
            {177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128},
            { 80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128},
        },
        {
            {  1,   1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
            {246,   1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
            {255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
        },
    },
    {
        {
            {198,  35, 237, 223, 193, 187, 162, 160, 145, 155,  62},
            {131,  45, 198, 221, 172, 176, 220, 157, 252, 221,   1},
            { 68,  47, 146, 208, 149, 167, 221, 162, 255, 223, 128},
        },
        {
            {  1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128},
            {184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128},
            { 81,  99, 181, 242, 176, 190, 249, 202, 255, 255, 128},
        },
        {
            {  1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128},
            { 99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128},
            { 23,  91, 163, 242, 170, 187, 247, 210, 255, 255, 128},
        },
        {
            {  1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128},
            {109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128},
            { 44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128},
        },
        {
            {  1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128},
            { 94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128},
            { 22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128},
        },
        {
            {  1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128},
            {124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128},
            { 35,  77, 181, 251, 193, 211, 255, 205, 128, 128, 128},
        },
        {
            {  1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128},
            {121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128},
            { 45,  99, 188, 251, 195, 217, 255, 224, 128, 128, 128},
        },
        {
            {  1,   1, 251, 255, 213, 255, 128, 128, 128, 128, 128},
            {203,   1, 248, 255, 255, 128, 128, 128, 128, 128, 128},
            {137,   1, 177, 255, 224, 255, 128, 128, 128, 128, 128},
        },
    },
    {
        {
            {253,   9, 248, 251, 207, 208, 255, 192, 128, 128, 128},
            {175,  13, 224, 243, 193, 185, 249, 198, 255, 255, 128},
            { 73,  17, 171, 221, 161, 179, 236, 167, 255, 234, 128},
        },
        {
            {  1,  95, 247, 253, 212, 183, 255, 255, 128, 128, 128},
            {239,  90, 244, 250, 211, 209, 255, 255, 128, 128, 128},
            {155,  77, 195, 248, 188, 195, 255, 255, 128, 128, 128},
        },
        {
            {  1,  24, 239, 251, 218, 219, 255, 205, 128, 128, 128},
            {201,  51, 219, 255, 196, 186, 128, 128, 128, 128, 128},
            { 69,  46, 190, 239, 201, 218, 255, 228, 128, 128, 128},
        },
        {
            {  1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128},
            {223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128},
            {141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128},
        },
        {
            {  1,  16, 248, 255, 255, 128, 128, 128, 128, 128, 128},
            {190,  36, 230, 255, 236, 255, 128, 128, 128, 128, 128},
            {149,   1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
        },
        {
            {  1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128},
            {247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128},
            {240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128},
        },
        {
            {  1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128},
            {213,  62, 250, 255, 255, 128, 128, 128, 128, 128, 128},
            { 55,  93, 255, 128, 128, 128, 128, 128, 128, 128, 128},
        },
        {
            {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
            {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
            {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
        },
    },
    {
        {
            {202,  24, 213, 235, 186, 191, 220, 160, 240, 175, 255},
            {126,  38, 182, 232, 169, 184, 228, 174, 255, 187, 128},
            { 61,  46, 138, 219, 151, 178, 240, 170, 255, 216, 128},
        },
        {
            {  1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128},
            {166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128},
            { 39,  77, 162, 232, 172, 180, 245, 178, 255, 255, 128},
        },
        {
            {  1,  52, 220, 246, 198, 199, 249, 220, 255, 255, 128},
            {124,  74, 191, 243, 183, 193, 250, 221, 255, 255, 128},
            { 24,  71, 130, 219, 154, 170, 243, 182, 255, 255, 128},
        },
        {
            {  1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128},
            {149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128},
            { 28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128},
        },
        {
            {  1,  81, 230, 252, 204, 203, 255, 192, 128, 128, 128},
            {123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128},
            { 20,  95, 153, 243, 164, 173, 255, 203, 128, 128, 128},
        },
        {
            {  1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128},
            {168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128},
            { 47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128},
        },
        {
            {  1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128},
            {141,  84, 213, 252, 201, 202, 255, 219, 128, 128, 128},
            { 42,  80, 160, 240, 162, 185, 255, 205, 128, 128, 128},
        },
        {
            {  1,   1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
            {244,   1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
            {238,   1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
        },
    },
};

// RFC 6386 §13.4: coeff_update_probs (each "no update" flag is coded
// with its own probability)
const uint8_t kCoeffUpdateProbs[4][8][3][11] = {
    {
        {
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
        },
        {
            {176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255},
            {249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255},
        },
        {
            {255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255},
            {234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
        },
        {
            {255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255},
        },
        {
            {255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
        },
        {
            {255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255},
        },
        {
            {255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255},
            {250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255},
            {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
        },
        {
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
        },
    },
    {
        {
            {217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255},
            {234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255},
        },
        {
            {255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255},
        },
        {
            {255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
        },
        {
            {255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
        },
        {
            {255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
        },
        {
            {255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
        },
        {
            {255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255},
            {250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
        },
        {
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
        },
    },
    {
        {
            {186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255},
            {234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255},
            {251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255},
        },
        {
            {255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255},
        },
        {
            {255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
        },
        {
            {255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
        },
        {
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
        },
        {
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
        },
        {
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
        },
        {
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
        },
    },
    {
        {
            {248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255},
            {248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255},
        },
        {
            {255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255},
            {246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255},
            {252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255},
        },
        {
            {255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255},
            {248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255},
            {253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255},
        },
        {
            {255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
        },
        {
            {255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255},
            {252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
        },
        {
            {255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255},
        },
        {
            {255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255},
            {250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
        },
        {
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
        },
    },
};

// RFC 6386 §17.2: mv_update_probs (MV probabilities are never updated)
const uint8_t kMvUpdateProbs[2][19] = {
    {237, 246, 253, 253, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254,
     250, 250, 252, 254, 254},
    {231, 243, 245, 253, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254,
     251, 251, 254, 254, 254},
};

// RFC 6386 §16.3: vp8_mode_contexts [count][tree node]
const int kModeContexts[6][4] = {
    {7, 1, 1, 143},     {14, 18, 14, 107},  {135, 64, 57, 68},
    {60, 56, 128, 65},  {159, 134, 128, 34}, {234, 188, 128, 28},
};

const int kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const int kBands[16] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7};

// RFC 6386 §11.2: kf_ymode_prob and kf_uv_mode_prob
const uint8_t kKfYModeProbs[4] = {145, 156, 163, 128};
const uint8_t kKfUvModeProbs[3] = {142, 114, 183};

// RFC 6386 §13.2: extra-bit probabilities of dct_cat1..6 and their bases
const uint8_t kCat1[] = {159, 0};
const uint8_t kCat2[] = {165, 145, 0};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130,
                         129, 0};
const uint8_t *const kCatProbs[6] = {kCat1, kCat2, kCat3, kCat4, kCat5, kCat6};
const int kCatBase[6] = {5, 7, 11, 19, 35, 67};
constexpr int kMaxCoeff = 2048;

// luma and chroma prediction modes (RFC 6386 §8.1's order)
enum { DC_PRED = 0, V_PRED = 1, H_PRED = 2, TM_PRED = 3 };

// block types of the coefficient probabilities (§13.3)
enum { TYPE_Y_AFTER_Y2 = 0, TYPE_Y2 = 1, TYPE_UV = 2 };

// The boolean entropy encoder of RFC 6386 §7.3.
class BoolEncoder {
  public:
    void put(int bit, int prob) {
        uint32_t split = 1 + (((range_ - 1) * uint32_t(prob)) >> 8);
        if (bit) {
            bottom_ += split;
            range_ -= split;
        } else {
            range_ = split;
        }
        while (range_ < 128) {
            range_ <<= 1;
            if (bottom_ & (1u << 31)) carry();
            bottom_ <<= 1;
            if (!--bit_count_) {
                out_.push_back(uint8_t(bottom_ >> 24));
                bottom_ &= (1u << 24) - 1;
                bit_count_ = 8;
            }
        }
    }
    void literal(uint32_t value, int bits) {
        for (int b = bits - 1; b >= 0; --b) put((value >> b) & 1, 128);
    }
    // libvpx's vp8_stop_encode: 32 zero bits at even odds push every
    // pending bit out
    const std::vector<uint8_t> &finish() {
        for (int i = 0; i < 32; ++i) put(0, 128);
        return out_;
    }

  private:
    void carry() {
        size_t i = out_.size();
        while (i > 0 && out_[i - 1] == 255) out_[--i] = 0;
        if (i > 0) ++out_[i - 1];
    }
    std::vector<uint8_t> out_;
    uint32_t range_ = 255;
    uint32_t bottom_ = 0;
    int bit_count_ = 24;
};

inline uint8_t clamp255(int v) { return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v); }

// libvpx vp8_short_fdct4x4_c: residual rows of `stride` -> 16 coefficients
void fdct4x4(const int16_t *in, int stride, int16_t *out) {
    int16_t tmp[16];
    for (int i = 0; i < 4; ++i) {
        const int16_t *ip = in + i * stride;
        int a1 = (ip[0] + ip[3]) * 8, b1 = (ip[1] + ip[2]) * 8;
        int c1 = (ip[1] - ip[2]) * 8, d1 = (ip[0] - ip[3]) * 8;
        int16_t *op = tmp + 4 * i;
        op[0] = int16_t(a1 + b1);
        op[2] = int16_t(a1 - b1);
        op[1] = int16_t((c1 * 2217 + d1 * 5352 + 14500) >> 12);
        op[3] = int16_t((d1 * 2217 - c1 * 5352 + 7500) >> 12);
    }
    for (int i = 0; i < 4; ++i) {
        const int16_t *ip = tmp + i;
        int a1 = ip[0] + ip[12], b1 = ip[4] + ip[8];
        int c1 = ip[4] - ip[8], d1 = ip[0] - ip[12];
        out[i] = int16_t((a1 + b1 + 7) >> 4);
        out[8 + i] = int16_t((a1 - b1 + 7) >> 4);
        out[4 + i] = int16_t(((c1 * 2217 + d1 * 5352 + 12000) >> 16) + (d1 != 0));
        out[12 + i] = int16_t((d1 * 2217 - c1 * 5352 + 51000) >> 16);
    }
}

// libvpx vp8_short_walsh4x4_c over the 16 luma DCs (a 4x4 array)
void walsh4x4(const int16_t *in, int16_t *out) {
    int16_t tmp[16];
    for (int i = 0; i < 4; ++i) {
        const int16_t *ip = in + 4 * i;
        int a1 = (ip[0] + ip[2]) * 4, d1 = (ip[1] + ip[3]) * 4;
        int c1 = (ip[1] - ip[3]) * 4, b1 = (ip[0] - ip[2]) * 4;
        int16_t *op = tmp + 4 * i;
        op[0] = int16_t(a1 + d1 + (a1 != 0));
        op[1] = int16_t(b1 + c1);
        op[2] = int16_t(b1 - c1);
        op[3] = int16_t(a1 - d1);
    }
    for (int i = 0; i < 4; ++i) {
        const int16_t *ip = tmp + i;
        int a1 = ip[0] + ip[8], d1 = ip[4] + ip[12];
        int c1 = ip[4] - ip[12], b1 = ip[0] - ip[8];
        int a2 = a1 + d1, b2 = b1 + c1, c2 = b1 - c1, d2 = a1 - d1;
        a2 += a2 < 0;
        b2 += b2 < 0;
        c2 += c2 < 0;
        d2 += d2 < 0;
        out[i] = int16_t((a2 + 3) >> 3);
        out[4 + i] = int16_t((b2 + 3) >> 3);
        out[8 + i] = int16_t((c2 + 3) >> 3);
        out[12 + i] = int16_t((d2 + 3) >> 3);
    }
}

// RFC 6386 §14.3: the inverse WHT, 16-bit intermediates as the decoder
void inv_walsh4x4(const int16_t *in, int16_t *out) {
    int16_t tmp[16];
    for (int i = 0; i < 4; ++i) {
        const int16_t *ip = in + i;
        int a1 = ip[0] + ip[12], b1 = ip[4] + ip[8];
        int c1 = ip[4] - ip[8], d1 = ip[0] - ip[12];
        tmp[i] = int16_t(a1 + b1);
        tmp[4 + i] = int16_t(c1 + d1);
        tmp[8 + i] = int16_t(a1 - b1);
        tmp[12 + i] = int16_t(d1 - c1);
    }
    for (int i = 0; i < 4; ++i) {
        const int16_t *ip = tmp + 4 * i;
        int a1 = ip[0] + ip[3], b1 = ip[1] + ip[2];
        int c1 = ip[1] - ip[2], d1 = ip[0] - ip[3];
        out[4 * i] = int16_t((a1 + b1 + 3) >> 3);
        out[4 * i + 1] = int16_t((c1 + d1 + 3) >> 3);
        out[4 * i + 2] = int16_t((a1 - b1 + 3) >> 3);
        out[4 * i + 3] = int16_t((d1 - c1 + 3) >> 3);
    }
}

// RFC 6386 §14.4: the inverse DCT added to the prediction in place. A
// block with only its DC adds (dc + 4) >> 3 everywhere, which is what
// the full transform gives it (and what libvpx's dc-only path adds).
void idct4x4_add(const int16_t *in, uint8_t *dst, int stride) {
    bool dc_only = true;
    for (int k = 1; k < 16 && dc_only; ++k) dc_only = in[k] == 0;
    if (dc_only) {
        int add = (in[0] + 4) >> 3;
        if (add)
            for (int r = 0; r < 4; ++r)
                for (int c = 0; c < 4; ++c) dst[r * stride + c] = clamp255(dst[r * stride + c] + add);
        return;
    }
    const int kC = 20091;  // cos(pi/8) * sqrt(2) - 1, Q16
    const int kS = 35468;  // sin(pi/8) * sqrt(2), Q16
    int16_t tmp[16];
    for (int i = 0; i < 4; ++i) {
        const int16_t *ip = in + i;
        int a1 = ip[0] + ip[8], b1 = ip[0] - ip[8];
        int t1 = (ip[4] * kS) >> 16;
        int t2 = ip[12] + ((ip[12] * kC) >> 16);
        int c1 = t1 - t2;
        t1 = ip[4] + ((ip[4] * kC) >> 16);
        t2 = (ip[12] * kS) >> 16;
        int d1 = t1 + t2;
        tmp[i] = int16_t(a1 + d1);
        tmp[12 + i] = int16_t(a1 - d1);
        tmp[4 + i] = int16_t(b1 + c1);
        tmp[8 + i] = int16_t(b1 - c1);
    }
    for (int i = 0; i < 4; ++i) {
        const int16_t *ip = tmp + 4 * i;
        int a1 = ip[0] + ip[2], b1 = ip[0] - ip[2];
        int t1 = (ip[1] * kS) >> 16;
        int t2 = ip[3] + ((ip[3] * kC) >> 16);
        int c1 = t1 - t2;
        t1 = ip[1] + ((ip[1] * kC) >> 16);
        t2 = (ip[3] * kS) >> 16;
        int d1 = t1 + t2;
        int16_t r[4] = {int16_t((a1 + d1 + 4) >> 3), int16_t((b1 + c1 + 4) >> 3),
                        int16_t((b1 - c1 + 4) >> 3), int16_t((a1 - d1 + 4) >> 3)};
        uint8_t *row = dst + i * stride;
        for (int c = 0; c < 4; ++c) row[c] = clamp255(row[c] + r[c]);
    }
}

// One quantizer step with its rounding: half a step for the DCs, a dead
// zone (3/8) for the rest, which leaves coefficients of noise at zero.
// The division is a multiplication by the step's reciprocal, rounded
// up: exact for every numerator under 2^32 / step.
struct Step {
    int step = 1, round = 0;
    uint64_t inv = uint64_t(1) << 32;

    Step() = default;
    Step(int s, bool dc) : step(s), round(dc ? s / 2 : s * 3 / 8),
                           inv(((uint64_t(1) << 32) + s - 1) / s) {}

    int16_t quantize(int coeff) const {
        int q = int((uint64_t(std::abs(coeff) + round) * inv) >> 32);
        q = std::min(q, kMaxCoeff);
        return int16_t(coeff < 0 ? -q : q);
    }
};

struct Quant {
    Step y1[2], y2[2], uv[2];  // {dc, ac}
};

Quant make_quant(int q) {
    Quant t;
    t.y1[0] = Step(kDcQ[q], true);
    t.y1[1] = Step(kAcQ[q], false);
    t.y2[0] = Step(kDcQ[q] * 2, true);
    t.y2[1] = Step(std::max(kAcQ[q] * 155 / 100, 8), false);
    t.uv[0] = Step(std::min(kDcQ[q], 132), true);
    t.uv[1] = Step(kAcQ[q], false);
    return t;
}

// One macroblock's coded data: quantized coefficients of its 25 blocks
// (0-15 Y, 16-19 U, 20-23 V, 24 Y2), each in natural order.
struct MbCoeffs {
    int16_t q[25][16];
    bool skip;
};

class Encoder {
  public:
    Encoder(int width, int height, int q_index)
        : w_(width), h_(height), mbw_((width + 15) / 16), mbh_((height + 15) / 16),
          yw_(mbw_ * 16), yh_(mbh_ * 16), cw_(mbw_ * 8), ch_(mbh_ * 8),
          q_index_(q_index), quant_(make_quant(q_index)),
          recon_(size_t(yw_) * yh_ * 3 / 2), next_(recon_.size()) {}

    size_t frame_bytes() const { return recon_.size(); }
    const std::vector<uint8_t> &payload() const { return payload_; }
    const std::vector<uint8_t> &reconstruction() const { return recon_; }
    bool has_reference() const { return have_ref_; }

    void encode(const uint8_t *i420, bool key) {
        const uint8_t *src[3] = {i420, i420 + size_t(yw_) * yh_,
                                 i420 + size_t(yw_) * yh_ + size_t(cw_) * ch_};
        uint8_t *dst[3] = {next_.data(), next_.data() + size_t(yw_) * yh_,
                           next_.data() + size_t(yw_) * yh_ + size_t(cw_) * ch_};
        const uint8_t *ref[3] = {recon_.data(), recon_.data() + size_t(yw_) * yh_,
                                 recon_.data() + size_t(yw_) * yh_ + size_t(cw_) * ch_};
        BoolEncoder tokens;
        std::vector<uint8_t> above(size_t(mbw_) * 9, 0);
        std::vector<uint8_t> ymodes(size_t(mbw_) * mbh_), uvmodes(ymodes.size());
        std::vector<uint8_t> skips(ymodes.size());
        MbCoeffs mb;
        for (int my = 0; my < mbh_; ++my) {
            uint8_t left[9] = {0};
            for (int mx = 0; mx < mbw_; ++mx) {
                size_t i = size_t(my) * mbw_ + mx;
                if (key) {
                    ymodes[i] = uint8_t(predict_intra(dst[0], yw_, src[0], mx, my, 16, nullptr,
                                                      nullptr));
                    uvmodes[i] = uint8_t(predict_intra(dst[1], cw_, src[1], mx, my, 8, dst[2],
                                                       src[2]));
                } else {
                    copy_block(ref[0], dst[0], yw_, mx * 16, my * 16, 16);
                    copy_block(ref[1], dst[1], cw_, mx * 8, my * 8, 8);
                    copy_block(ref[2], dst[2], cw_, mx * 8, my * 8, 8);
                }
                code_residual(src, dst, mx, my, &mb);
                skips[i] = mb.skip;
                if (mb.skip) {
                    std::memset(above.data() + size_t(mx) * 9, 0, 9);
                    std::memset(left, 0, sizeof(left));
                } else {
                    write_tokens(&tokens, mb, above.data() + size_t(mx) * 9, left);
                }
            }
        }
        const std::vector<uint8_t> &part2 = tokens.finish();
        BoolEncoder header;
        write_header(&header, key, ymodes, uvmodes, skips);
        const std::vector<uint8_t> &part1 = header.finish();
        if (part1.size() >= (size_t(1) << 19))
            throw std::runtime_error("the first partition outgrew its 19-bit size");

        payload_.clear();
        uint32_t tag = (key ? 0u : 1u) | (0u << 1) | (1u << 4) | (uint32_t(part1.size()) << 5);
        payload_.push_back(uint8_t(tag));
        payload_.push_back(uint8_t(tag >> 8));
        payload_.push_back(uint8_t(tag >> 16));
        if (key) {
            const uint8_t start[7] = {0x9d, 0x01, 0x2a, uint8_t(w_), uint8_t(w_ >> 8),
                                      uint8_t(h_), uint8_t(h_ >> 8)};
            payload_.insert(payload_.end(), start, start + 7);
        }
        payload_.insert(payload_.end(), part1.begin(), part1.end());
        payload_.insert(payload_.end(), part2.begin(), part2.end());
        recon_.swap(next_);
        have_ref_ = true;
    }

  private:
    static void copy_block(const uint8_t *from, uint8_t *to, int stride, int x, int y, int n) {
        for (int r = 0; r < n; ++r)
            std::memcpy(to + size_t(y + r) * stride + x, from + size_t(y + r) * stride + x, n);
    }

    // Build the four predictions of an n x n block (16 luma, 8 chroma:
    // with `plane2`, the V plane, scored together with U), write the
    // one nearest the source into `recon`, and return its mode. Edges
    // as the decoder has them (§12.2): 127 above row 0, 129 left of
    // column 0, the above-left pixel 127 on row 0 and else 129 on
    // column 0.
    int predict_intra(uint8_t *recon, int stride, const uint8_t *src, int mx, int my, int n,
                      uint8_t *recon2, const uint8_t *src2) const {
        int x = mx * n, y = my * n;
        struct Edges {
            uint8_t above[16], left[16];
            int top_left, dc;
        } edges[2];
        long sse[4] = {0, 0, 0, 0};
        int planes = recon2 ? 2 : 1;
        for (int p = 0; p < planes; ++p) {
            const uint8_t *rec = p ? recon2 : recon;
            const uint8_t *s = p ? src2 : src;
            Edges &e = edges[p];
            for (int k = 0; k < n; ++k) {
                e.above[k] = my ? rec[size_t(y - 1) * stride + x + k] : 127;
                e.left[k] = mx ? rec[size_t(y + k) * stride + x - 1] : 129;
            }
            e.top_left = !my ? 127 : !mx ? 129 : rec[size_t(y - 1) * stride + x - 1];
            e.dc = 128;
            if (mx || my) {
                int sum = 0, shift = (n == 16 ? 3 : 2) + (my > 0) + (mx > 0);
                for (int k = 0; k < n; ++k) sum += (my ? e.above[k] : 0) + (mx ? e.left[k] : 0);
                e.dc = (sum + (1 << (shift - 1))) >> shift;
            }
            // the four predictions' SSE against the source, unbuilt
            for (int r = 0; r < n; ++r) {
                const uint8_t *srow = s + size_t(y + r) * stride + x;
                int l = e.left[r], lt = e.left[r] - e.top_left;
                int s0 = 0, s1 = 0, s2 = 0, s3 = 0;
                for (int c = 0; c < n; ++c) {
                    int v = srow[c];
                    int d0 = v - e.dc, d1 = v - e.above[c], d2 = v - l;
                    int d3 = v - clamp255(lt + e.above[c]);
                    s0 += d0 * d0;
                    s1 += d1 * d1;
                    s2 += d2 * d2;
                    s3 += d3 * d3;
                }
                sse[DC_PRED] += s0;
                sse[V_PRED] += s1;
                sse[H_PRED] += s2;
                sse[TM_PRED] += s3;
            }
        }
        int best = 0;
        for (int m = 1; m < 4; ++m)
            if (sse[m] < sse[best]) best = m;
        for (int p = 0; p < planes; ++p) {
            uint8_t *rec = p ? recon2 : recon;
            const Edges &e = edges[p];
            for (int r = 0; r < n; ++r) {
                uint8_t *row = rec + size_t(y + r) * stride + x;
                for (int c = 0; c < n; ++c) {
                    row[c] = best == DC_PRED  ? uint8_t(e.dc)
                             : best == V_PRED ? e.above[c]
                             : best == H_PRED ? e.left[r]
                                              : clamp255(e.left[r] + e.above[c] - e.top_left);
                }
            }
        }
        return best;
    }

    // Transform and quantize the macroblock's residual against the
    // prediction already in `dst`, then add the decoder's reconstruction
    // of it to `dst`.
    void code_residual(const uint8_t *const src[3], uint8_t *const dst[3], int mx, int my,
                       MbCoeffs *mb) const {
        int16_t coeff[25][16];
        int16_t diff[16 * 16];
        // luma: 16 blocks, their DCs into the Y2 block
        const uint8_t *s = src[0] + size_t(my) * 16 * yw_ + mx * 16;
        uint8_t *d = dst[0] + size_t(my) * 16 * yw_ + mx * 16;
        for (int r = 0; r < 16; ++r)
            for (int c = 0; c < 16; ++c)
                diff[r * 16 + c] = int16_t(s[size_t(r) * yw_ + c] - d[size_t(r) * yw_ + c]);
        int16_t dcs[16];
        for (int b = 0; b < 16; ++b) {
            fdct4x4(diff + (b >> 2) * 64 + (b & 3) * 4, 16, coeff[b]);
            dcs[b] = coeff[b][0];
        }
        walsh4x4(dcs, coeff[24]);
        // chroma: 4 blocks a plane
        for (int p = 1; p < 3; ++p) {
            const uint8_t *cs = src[p] + size_t(my) * 8 * cw_ + mx * 8;
            const uint8_t *cd = dst[p] + size_t(my) * 8 * cw_ + mx * 8;
            for (int r = 0; r < 8; ++r)
                for (int c = 0; c < 8; ++c)
                    diff[r * 8 + c] = int16_t(cs[size_t(r) * cw_ + c] - cd[size_t(r) * cw_ + c]);
            for (int b = 0; b < 4; ++b)
                fdct4x4(diff + (b >> 1) * 32 + (b & 1) * 4, 8, coeff[16 + (p - 1) * 4 + b]);
        }
        bool any = false;
        for (int b = 0; b < 25; ++b) {
            const Step *step = b == 24 ? quant_.y2 : b < 16 ? quant_.y1 : quant_.uv;
            for (int k = 0; k < 16; ++k) {
                int16_t q = (b < 16 && k == 0) ? 0 : step[k ? 1 : 0].quantize(coeff[b][k]);
                mb->q[b][k] = q;
                any |= q != 0;
            }
        }
        mb->skip = !any;
        if (mb->skip) return;  // the decoder adds nothing: dst holds the prediction
        // the decoder's dequantization (16-bit products), inverse WHT, IDCT
        int16_t dq[16], y2dc[16];
        for (int k = 0; k < 16; ++k)
            dq[k] = int16_t(mb->q[24][k] * quant_.y2[k ? 1 : 0].step);
        inv_walsh4x4(dq, y2dc);
        for (int b = 0; b < 16; ++b) {
            int16_t blk[16];
            blk[0] = y2dc[b];
            for (int k = 1; k < 16; ++k) blk[k] = int16_t(mb->q[b][k] * quant_.y1[1].step);
            idct4x4_add(blk, d + size_t((b >> 2) * 4) * yw_ + (b & 3) * 4, yw_);
        }
        for (int p = 1; p < 3; ++p) {
            uint8_t *cd = dst[p] + size_t(my) * 8 * cw_ + mx * 8;
            for (int b = 0; b < 4; ++b) {
                const int16_t *q = mb->q[16 + (p - 1) * 4 + b];
                int16_t blk[16];
                for (int k = 0; k < 16; ++k) blk[k] = int16_t(q[k] * quant_.uv[k ? 1 : 0].step);
                idct4x4_add(blk, cd + size_t((b >> 1) * 4) * cw_ + (b & 1) * 4, cw_);
            }
        }
    }

    // §13: one block's tokens; returns whether it has a non-zero
    // coefficient (its above/left context for the next blocks)
    static int write_block(BoolEncoder *e, const int16_t *q, int type, int first, int ctx) {
        int last = -1;
        for (int i = first; i < 16; ++i)
            if (q[kZigzag[i]]) last = i;
        const uint8_t *p = kCoeffProbs[type][kBands[first]][ctx];
        if (last < 0) {
            e->put(0, p[0]);  // dct_eob
            return 0;
        }
        bool after_zero = false;
        for (int i = first; i <= last; ++i) {
            p = kCoeffProbs[type][kBands[i]][ctx];
            int v = q[kZigzag[i]];
            if (!after_zero) e->put(1, p[0]);  // not dct_eob
            if (!v) {
                e->put(0, p[1]);  // DCT_0
                ctx = 0;
                after_zero = true;
                continue;
            }
            e->put(1, p[1]);
            int a = std::abs(v);
            if (a == 1) {
                e->put(0, p[2]);
                ctx = 1;
            } else {
                e->put(1, p[2]);
                ctx = 2;
                if (a <= 4) {
                    e->put(0, p[3]);
                    if (a == 2) {
                        e->put(0, p[4]);
                    } else {
                        e->put(1, p[4]);
                        e->put(a == 4, p[5]);
                    }
                } else {
                    int cat = a <= 6 ? 0 : a <= 10 ? 1 : a <= 18 ? 2 : a <= 34 ? 3
                              : a <= 66 ? 4 : 5;
                    e->put(1, p[3]);
                    if (cat < 2) {
                        e->put(0, p[6]);
                        e->put(cat, p[7]);
                    } else {
                        e->put(1, p[6]);
                        e->put(cat >= 4, p[8]);
                        e->put(cat & 1, p[9 + (cat >= 4)]);
                    }
                    const uint8_t *cp = kCatProbs[cat];
                    int bits = 0;
                    while (cp[bits]) ++bits;
                    int extra = a - kCatBase[cat];
                    for (int k = 0; k < bits; ++k) e->put((extra >> (bits - 1 - k)) & 1, cp[k]);
                }
            }
            e->put(v < 0, 128);
            after_zero = false;
        }
        if (last < 15) e->put(0, kCoeffProbs[type][kBands[last + 1]][ctx][0]);
        return 1;
    }

    // a macroblock's tokens in §13's order: Y2, the 16 Y, 4 U, 4 V;
    // `above`/`left`: the 9 contexts (Y 0-3, U 4-5, V 6-7, Y2 8)
    static void write_tokens(BoolEncoder *e, const MbCoeffs &mb, uint8_t *above,
                             uint8_t *left) {
        above[8] = left[8] = uint8_t(write_block(e, mb.q[24], TYPE_Y2, 0, above[8] + left[8]));
        for (int b = 0; b < 16; ++b) {
            uint8_t &a = above[b & 3], &l = left[b >> 2];
            a = l = uint8_t(write_block(e, mb.q[b], TYPE_Y_AFTER_Y2, 1, a + l));
        }
        for (int p = 0; p < 2; ++p) {
            for (int b = 0; b < 4; ++b) {
                uint8_t &a = above[4 + 2 * p + (b & 1)], &l = left[4 + 2 * p + (b >> 1)];
                a = l = uint8_t(write_block(e, mb.q[16 + 4 * p + b], TYPE_UV, 0, a + l));
            }
        }
    }

    // §9 and §19.2: the frame header, then §19.3's per-macroblock
    // header of every macroblock
    void write_header(BoolEncoder *e, bool key, const std::vector<uint8_t> &ymodes,
                      const std::vector<uint8_t> &uvmodes,
                      const std::vector<uint8_t> &skips) const {
        if (key) {
            e->literal(0, 1);  // color_space
            e->literal(0, 1);  // clamping_type: the decoder clamps
        }
        e->literal(0, 1);  // segmentation_enabled
        e->literal(0, 1);  // filter_type
        e->literal(0, 6);  // loop_filter_level: no loop filter
        e->literal(0, 3);  // sharpness_level
        e->literal(0, 1);  // loop_filter_adj_enable
        e->literal(0, 2);  // log2_nbr_of_dct_partitions: one
        e->literal(uint32_t(q_index_), 7);  // y_ac_qi
        for (int k = 0; k < 5; ++k) e->literal(0, 1);  // no delta_q
        if (key) {
            e->literal(1, 1);  // refresh_entropy_probs
        } else {
            e->literal(0, 1);  // refresh_golden_frame
            e->literal(0, 1);  // refresh_alternate_frame
            e->literal(0, 2);  // copy_buffer_to_golden: none
            e->literal(0, 2);  // copy_buffer_to_alternate: none
            e->literal(0, 1);  // sign_bias_golden
            e->literal(0, 1);  // sign_bias_alternate
            e->literal(1, 1);  // refresh_entropy_probs
            e->literal(1, 1);  // refresh_last
        }
        for (int i = 0; i < 4; ++i)
            for (int j = 0; j < 8; ++j)
                for (int k = 0; k < 3; ++k)
                    for (int l = 0; l < 11; ++l) e->put(0, kCoeffUpdateProbs[i][j][k][l]);
        e->literal(1, 1);  // mb_no_coeff_skip
        long coded = 0;
        for (uint8_t s : skips) coded += !s;
        int prob_skip_false = int(std::clamp<long>(
            (coded * 256 + long(skips.size()) / 2) / long(skips.size()), 1, 255));
        e->literal(uint32_t(prob_skip_false), 8);
        const int prob_intra = 1, prob_last = 255;
        if (!key) {
            e->literal(prob_intra, 8);
            e->literal(prob_last, 8);
            e->literal(128, 8);  // prob_gf (unused: no golden reference)
            e->literal(0, 1);    // intra_16x16_prob_update_flag
            e->literal(0, 1);    // intra_chroma_prob_update_flag
            for (int i = 0; i < 2; ++i)
                for (int j = 0; j < 19; ++j) e->put(0, kMvUpdateProbs[i][j]);
        }
        for (int my = 0; my < mbh_; ++my) {
            for (int mx = 0; mx < mbw_; ++mx) {
                size_t i = size_t(my) * mbw_ + mx;
                e->put(skips[i], prob_skip_false);
                if (key) {
                    // kf_ymode_tree (§11.2): DC 100, V 101, H 110, TM 111
                    int m = ymodes[i];
                    e->put(1, kKfYModeProbs[0]);
                    e->put(m >= H_PRED, kKfYModeProbs[1]);
                    e->put(m & 1, kKfYModeProbs[m >= H_PRED ? 3 : 2]);
                    // uv_mode_tree: DC 0, V 10, H 110, TM 111
                    int u = uvmodes[i];
                    e->put(u != DC_PRED, kKfUvModeProbs[0]);
                    if (u != DC_PRED) {
                        e->put(u != V_PRED, kKfUvModeProbs[1]);
                        if (u != V_PRED) e->put(u == TM_PRED, kKfUvModeProbs[2]);
                    }
                } else {
                    e->put(1, prob_intra);  // is_inter_mb
                    e->put(0, prob_last);   // LAST
                    // find_near_mvs with every vector zero: above and
                    // left inside the frame count 2 each, above-left 1,
                    // all into cnt[0]; nearest, near and split count 0
                    int cnt0 = (my ? 2 : 0) + (mx ? 2 : 0) + (mx && my ? 1 : 0);
                    // mv_ref_tree: ZEROMV is 110
                    e->put(1, kModeContexts[cnt0][0]);
                    e->put(1, kModeContexts[0][1]);
                    e->put(0, kModeContexts[0][2]);
                }
            }
        }
    }

    int w_, h_, mbw_, mbh_, yw_, yh_, cw_, ch_, q_index_;
    Quant quant_;
    std::vector<uint8_t> recon_, next_, payload_;
    bool have_ref_ = false;
};

void set_error(char *err, int err_len, const std::string &msg) {
    if (err && err_len > 0) std::snprintf(err, size_t(err_len), "%s", msg.c_str());
}

}  // namespace

extern "C" {

int evam_vp8_version() { return 1; }

// A VP8 encoder of width x height frames at quantizer index q_index
// (0-127); nullptr with `err` set when the arguments are out of range.
void *evam_vp8_new(int width, int height, int q_index, char *err, int err_len) {
    if (width < 1 || height < 1 || width > 16383 || height > 16383) {
        set_error(err, err_len, "vp8: width and height must be 1..16383, got " +
                                    std::to_string(width) + "x" + std::to_string(height));
        return nullptr;
    }
    if (q_index < 0 || q_index > 127) {
        set_error(err, err_len, "vp8: q_index must be 0..127, got " + std::to_string(q_index));
        return nullptr;
    }
    return new Encoder(width, height, q_index);
}

void evam_vp8_free(void *enc) { delete static_cast<Encoder *>(enc); }

// Encode one frame: `i420` holds the Y, U and V planes at the
// macroblock-aligned size (width and height rounded up to 16), one
// after another. A keyframe unless `keyframe` is 0, which codes an
// inter frame against the last reconstruction. Returns the payload's
// size (read it with evam_vp8_payload), or -1 with `err` set.
long evam_vp8_encode(void *enc, const uint8_t *i420, int keyframe, char *err, int err_len) {
    Encoder *e = static_cast<Encoder *>(enc);
    if (!keyframe && !e->has_reference()) {
        set_error(err, err_len, "vp8: an inter frame needs a frame before it");
        return -1;
    }
    try {
        e->encode(i420, keyframe != 0);
    } catch (const std::exception &exc) {
        set_error(err, err_len, std::string("vp8: ") + exc.what());
        return -1;
    }
    return long(e->payload().size());
}

void evam_vp8_payload(void *enc, uint8_t *out) {
    const std::vector<uint8_t> &p = static_cast<Encoder *>(enc)->payload();
    std::memcpy(out, p.data(), p.size());
}

// The last frame's reconstruction (what a decoder outputs), as the
// macroblock-aligned I420 buffer of evam_vp8_encode.
void evam_vp8_reconstruction(void *enc, uint8_t *i420) {
    const std::vector<uint8_t> &r = static_cast<Encoder *>(enc)->reconstruction();
    std::memcpy(i420, r.data(), r.size());
}

}  // extern "C"

// A cascade's levels, passed by value to the cascade kernels of
// fused_kernels.cu and m31_kernels.cu (the layout of ops/unrolled.py's
// _Levels): the xor distance of each level and its form (0: 1-mul, 1:
// 2-mul reading the next row of the A coefficients).

#pragma once

constexpr int MAX_LEVELS = 16;  // cascade levels per launch

struct Levels {
  int k;
  int half[MAX_LEVELS];
  int kind[MAX_LEVELS];
};

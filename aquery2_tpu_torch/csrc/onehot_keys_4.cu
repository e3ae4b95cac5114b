// onehot_segment_sums' keyed form with 4 keys: its kernels, built beside the
// other key counts' (onehot_segment_sums.cuh).
#include "onehot_segment_sums.cuh"

template aq_onehot::Kernel aq_onehot::kernel_for<4>(int, bool, bool);

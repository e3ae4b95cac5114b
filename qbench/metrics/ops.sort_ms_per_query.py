"""ops.sort_ms_per_query: device time of the sort kernels per query, ms.

The device events of the traced window whose names hold one of NAMES
(CUB's radix sort kernels, which ``torch.sort`` and ``torch.argsort``
launch, and torch's own sort kernels), summed, over the queries
completed in the window. Nothing where no sort kernel ran."""

NAMES = ("RadixSort", "radixSort", "radix_sort", "bitonicSort",
         "segmented_sort", "SegmentedSort", "sort_postprocess",
         "sortKeyValueInplace")


def read(w):
    secs, n = w.device_seconds(lambda name: any(k in name for k in NAMES))
    if not n or not w.queries:
        return None
    return secs / w.queries * 1e3

"""Shape and tier constants of aquery2_tpu_torch.

The values are those of ``aquery2_tpu/config.py``, so capacities, tier
choice and group order line up with the JAX package in cross-checks. The
port has no environment switches: a CUDA tensor always takes its kernel,
a CPU tensor its plain version (ops/kernels.py).
"""

from __future__ import annotations

# Minimum padded capacity for a device column.
MIN_CAPACITY = 1024

# Dense (perfect-hash) group-by tier bound: key domains of at most this
# many slots reduce into dense accumulators instead of sorting. Kept at
# the JAX package's value so both packages pick the same tier; the port's
# own bound waits for measurements on the card.
ONEHOT_MATMUL_MAX_GROUPS = 512

# var and stddev divide by n + 1, as the reference engine does: the JAX
# package mirrors it under ``config.strict_reference_semantics``, which is
# True unless its environment switch turns it off. The port has no switch,
# so it keeps the default.
STRICT_REFERENCE_SEMANTICS = True

# Dense-lookup join bound: the star join (engine/fused_star.py) and the
# count join's histogram route (engine/fused_join.py) build a table over
# the build keys' value domain when it spans at most this many slots. The
# JAX package's value, so both packages take the star path on the same
# shapes (the port has no general join to fall back on).
PERFECT_HASH_MAX_DOMAIN = 1 << 27


def bucket_size(n: int) -> int:
    """Padded capacity for a logical length ``n``: buckets are
    {2^k, 3·2^(k-1)}, two per octave, at least MIN_CAPACITY."""
    cap = MIN_CAPACITY
    while cap < n:
        mid = cap + (cap >> 1)          # 3·2^(k-1)
        if n <= mid and mid % 1024 == 0:
            return mid
        cap <<= 1
    return cap

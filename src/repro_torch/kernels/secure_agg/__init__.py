"""Secure-aggregation kernels: the counter-PRG masks, the Z_2^32 codec,
the plain PyTorch versions, the CUDA kernel wrappers and the dispatch."""
from repro_torch.kernels.secure_agg import field, masking
from repro_torch.kernels.secure_agg.ops import (
    masked_rolling_update, normalize_seed, rolling_update_flat,
    rolling_update_tree,
)
from repro_torch.kernels.secure_agg.ref import (
    field_shares_reference, field_wsum_reference, int_blend_params,
    int_blend_rows, masked_field_wsum_reference,
    masked_rolling_update_reference, rolling_update_int_reference,
    rolling_update_reference,
)

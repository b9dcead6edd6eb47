from repro_torch.sharding.api import (
    LogicalRules, current_rules, logical_spec, logical_shard, use_rules,
    SINGLE_POD_RULES, MULTI_POD_RULES, FEDERATION_RULES, INSTITUTION_AXIS,
    param_sharding_tree, institution_spec, stacked_sharding,
    make_institution_mesh, institution_rows, all_gather_rows,
    mesh_axis_sizes, mesh_barrier, rank_device, spec_placements,
    host_staged,
)

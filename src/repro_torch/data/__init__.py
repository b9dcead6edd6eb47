"""Data pipelines: synthetic GLENDA-like frames, hospital splits and the
device tier's per-device shards."""
from repro_torch.data.pipeline import (
    DeviceShardSpec, DirichletPartitioner, SyntheticGlendaDataset,
    class_centroids, institution_class_mixes, make_centroid_pull_update,
    make_device_data_fn,
)

__all__ = [
    "DeviceShardSpec", "DirichletPartitioner", "SyntheticGlendaDataset",
    "class_centroids", "institution_class_mixes",
    "make_centroid_pull_update", "make_device_data_fn",
]

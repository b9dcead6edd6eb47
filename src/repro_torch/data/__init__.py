"""Data pipelines: synthetic GLENDA-like frames, hospital splits, the
language models' synthetic token corpus and the device tier's per-device
shards."""
from repro_torch.data.pipeline import (
    DataConfig, DeviceShardSpec, DirichletPartitioner, SyntheticGlendaDataset,
    SyntheticTokenDataset, class_centroids, institution_batches,
    institution_class_mixes, make_batch_specs, make_centroid_pull_update,
    make_device_data_fn,
)

__all__ = [
    "DataConfig", "DeviceShardSpec", "DirichletPartitioner",
    "SyntheticGlendaDataset", "SyntheticTokenDataset", "class_centroids",
    "institution_batches", "institution_class_mixes", "make_batch_specs",
    "make_centroid_pull_update", "make_device_data_fn",
]

"""Datasets, loaders, samplers, ``save``/``load`` and checkpoint
retention: the port of ``paddle_tpu/io`` (its names)."""
from .checkpoint import CheckpointManager, load_sharded, save_sharded
from .dataloader import (BatchSampler, ChainDataset, ComposeDataset,
                         DataLoader, Dataset, DistributedBatchSampler,
                         IterableDataset, RandomSampler, Sampler,
                         SequenceSampler, Subset, TensorDataset,
                         WeightedRandomSampler, default_collate_fn,
                         get_worker_info, random_split)
from .save_load import load, save

__all__ = ["CheckpointManager", "load_sharded", "save_sharded",
           "BatchSampler", "ChainDataset", "ComposeDataset", "DataLoader",
           "Dataset", "DistributedBatchSampler", "IterableDataset",
           "RandomSampler", "Sampler", "SequenceSampler", "Subset",
           "TensorDataset", "WeightedRandomSampler", "default_collate_fn",
           "get_worker_info", "random_split", "load", "save"]

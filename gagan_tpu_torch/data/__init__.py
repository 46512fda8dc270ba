"""Input pipelines of the port: the image dataset, its sampler and loader."""

from .dataset import ImageFolderDataset, InfiniteSampler, data_loader

__all__ = ["ImageFolderDataset", "InfiniteSampler", "data_loader"]

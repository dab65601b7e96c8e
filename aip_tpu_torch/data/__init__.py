"""Host-side data loading (port of ``aip_tpu.data``)."""

from aip_tpu_torch.data.images import FlatFolderDataset, infinite_batches, train_transform

from .ra import (RaggedArray, save, load, where, zeros_like,
                 partition_list, partition_indices)
from .device import pad_ragged, unpad_ragged, PaddedRagged, to_padded

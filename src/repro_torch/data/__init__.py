from .loader import batches, num_batches
from .partition import (dirichlet_partition, label_sorted_shards,
                        lognormal_sizes, partition_by_sizes)
from .synthetic import (ArrayDataset, make_char_lm, make_image_classification,
                        make_speech_commands, make_token_lm)

__all__ = ["batches", "num_batches", "dirichlet_partition",
           "label_sorted_shards", "lognormal_sizes", "partition_by_sizes",
           "ArrayDataset", "make_char_lm", "make_image_classification",
           "make_speech_commands", "make_token_lm"]

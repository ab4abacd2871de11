from .pipeline import (BatchSpec, DataConfig, make_batch_specs,
                       synthetic_batch, synthetic_batches)

__all__ = ["BatchSpec", "DataConfig", "make_batch_specs", "synthetic_batch",
           "synthetic_batches"]

from aquery2_tpu_torch.storage.table import Column, StringDict, Table
from aquery2_tpu_torch.storage.result import Result
from aquery2_tpu_torch.storage.catalog import Catalog

__all__ = ["Column", "StringDict", "Table", "Result", "Catalog"]

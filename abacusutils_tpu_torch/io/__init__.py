from .asdf_file import AsdfFile, open_asdf, set_nthreads, write_asdf
from .table import Table

__all__ = ['AsdfFile', 'open_asdf', 'write_asdf', 'set_nthreads', 'Table']

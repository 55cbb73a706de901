from .decomposition import decompose, is_decomposeable_module

__all__ = ["decompose", "is_decomposeable_module"]

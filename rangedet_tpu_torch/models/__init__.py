from .detector import RangeDet  # noqa: F401

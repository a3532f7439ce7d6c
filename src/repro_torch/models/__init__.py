"""The dense and griffin LMs with analog matmul hooks (port of ``repro/models``)."""

"""Dense transformer LM with analog matmul hooks (port of ``repro/models``)."""

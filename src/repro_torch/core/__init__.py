# node, pool, pipeline and the operator IR of the port (see repro_torch/__init__.py)

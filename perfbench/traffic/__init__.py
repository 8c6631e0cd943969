"""Traffic generators: each reads the parameters of a cell's ``traffic``
block (``perfbench/cells/<cell>.json``) and the run's seed."""

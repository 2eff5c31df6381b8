"""Several devices: the batch-sharded mesh (`mesh.py`) and the
ring-sharded NTT and CKKS multiplication (`limb_ntt.py`)."""

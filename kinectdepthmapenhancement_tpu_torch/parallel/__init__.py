"""Multi-process execution on torch.distributed, one process per rank:
the ('data', 'x') mesh (mesh.py), initialisation, data-parallel batches
and the rank launcher (multihost.py), halo exchange on width tiles
(halo.py), the JBF on width tiles (stencil_shard.py), and the sharded KDE
step with its dryrun (sharding.py).  The counterpart of the JAX package's
parallel/; nothing here runs at import."""

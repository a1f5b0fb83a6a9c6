"""Multi-card execution on ``torch.distributed``: channel, slab and transmit
sharding (:mod:`.sharding`) and the multi-host feeders (:mod:`.multihost`),
the counterparts of ``ogl_beamforming_tpu.parallel``."""

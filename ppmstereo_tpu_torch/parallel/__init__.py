"""Multi-process modes: the process mesh, the ring play attention, a local group launcher."""

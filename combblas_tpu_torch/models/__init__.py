"""Applications of the port (counterpart of ``combblas_tpu/models/``) and
the batch-lane conventions they share."""

#: Lane-padding sentinel of every batched multi-root search: a source slot
#: holding PAD_ROOT is an inert lane that discovers nothing. Negative, so
#: it never collides with a vertex id.
PAD_ROOT: int = -1

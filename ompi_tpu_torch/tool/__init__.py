"""Tools layer (port of ``ompi_tpu/tool``): SPC counters, MPI_T,
monitoring (point-to-point matrices and collective accounting) and the
memory checker."""

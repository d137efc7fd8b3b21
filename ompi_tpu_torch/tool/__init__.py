"""Tools layer (port of ``ompi_tpu/tool``): SPC counters, MPI_T, and the
coll half of monitoring.  The memory checker is not ported yet."""

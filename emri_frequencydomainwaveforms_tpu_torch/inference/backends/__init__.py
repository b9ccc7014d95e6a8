"""Chain backends: in memory and HDF5."""

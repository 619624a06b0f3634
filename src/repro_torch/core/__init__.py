"""DLRM model core."""

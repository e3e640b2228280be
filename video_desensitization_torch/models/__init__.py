"""Detection networks (NCHW inside, reference torch state_dict layout)."""

"""Host core: f64-generated tables, factorization, complex split/merge, naive DFT oracle."""

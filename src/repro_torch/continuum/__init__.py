"""Computing-continuum resource tiers."""

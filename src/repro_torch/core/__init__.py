"""LightLDA's sampler core: alias tables, the MH chain, point estimates."""

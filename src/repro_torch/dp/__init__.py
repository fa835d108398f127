"""Differential privacy at the up-link codec seam (mechanisms only; the
RDP accountant is not ported yet)."""

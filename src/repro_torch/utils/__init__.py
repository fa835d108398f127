"""PRNG, XLA-exact math, param trees and device helpers."""

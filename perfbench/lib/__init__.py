"""The benchmark's own machinery: manifest lookup, seeded weights, the
traced window, the correctness comparison."""

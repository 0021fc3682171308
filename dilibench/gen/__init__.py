"""The benchmark's input generators: frozen copies of the port's dataset
and workload generators, and YCSB's hashed record keys and scrambled
zipfian key chooser."""

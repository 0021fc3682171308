"""The DILI lookup kernel: CUDA source under `csrc/`, its loader and
wrapper (`dili_search`), its plain PyTorch version (`ref`) and the table
packing and dispatch (`ops`)."""

"""setup_s: process start to the window's first block: imports, CUDA
initialisation, the IRs and the input pool made from the seed, the model
build with its device prep (and, in a checkout's first run, the kernels'
nvcc builds), the state and the warm-up."""

def read(run):
    return run.t_first_read - run.t_proc

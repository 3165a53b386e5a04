"""Host seconds of the port's first library load (``_build.load_library``):
nvcc in a checkout that has not built them, ``ctypes`` loads after."""


def read(ctx):
    return ctx.setup.get("kernel_load_s")

// CON003 fixture: the CUDA source kernels/good.py binds.  Never built.
extern "C" int good_error_string(int code) { return code; }

# Native components: threaded dependency engine, RecordIO fast path,
# libjpeg decode+augment kernel, and the flat MX* C ABI.
# Parity: the reference's Makefile builds libmxnet.so from src/; here the
# XLA path needs no native device kernels, so the native library covers
# the host-side runtime (src/engine.cc, src/recordio.cc, src/image.cc)
# with the C ABI (src/c_api.cc) as a separate `make capi` library, and the
# PyTorch port's C ABI over the same header as `make capi-torch`.
CXX ?= g++
CXXFLAGS ?= -O2 -std=c++17 -fPIC -Wall -pthread

LIBDIR := lib
SRCS := src/engine.cc src/recordio.cc src/image.cc
OBJS := $(SRCS:src/%.cc=$(LIBDIR)/%.o)
# link libjpeg only where the header (and thus the decode kernel) exists;
# src/image.cc degrades to a stub otherwise and the engine/recordio parts
# of the library still build
HAS_JPEG := $(shell printf '\043include <cstdio>\n\043include <jpeglib.h>\nint main(){return 0;}\n' | $(CXX) -x c++ - -ljpeg -o /dev/null 2>/dev/null && echo 1)
LDLIBS := $(if $(HAS_JPEG),-ljpeg,)

PY_INCLUDES := $(shell python3-config --includes 2>/dev/null)
PY_LDFLAGS := $(shell python3-config --ldflags --embed 2>/dev/null || python3-config --ldflags 2>/dev/null)

all: $(LIBDIR)/libmxtpu.so $(if $(HAS_JPEG),tools/im2rec,)

# native dataset packer (reference tools/im2rec.cc): multi-threaded
# decode/resize/encode -> RecordIO; needs libjpeg
tools/im2rec: src/im2rec.cc src/image_codec.h $(LIBDIR)/recordio.o
	$(CXX) $(CXXFLAGS) src/im2rec.cc $(LIBDIR)/recordio.o -o $@ $(LDLIBS)

# Python-free PJRT predictor (reference amalgamation/mxnet_predict0.cc
# analog).  The PJRT C API header ships in the tensorflow wheel (OpenXLA,
# Apache-2.0); located at build time, no TF linkage — the binary only
# needs libdl and a PJRT plugin .so at runtime.  Expanded only by that
# target's recipe (`=`, not `:=`): the tensorflow import takes seconds,
# and every other make run would pay it.
PJRT_INC = $(shell python3 -c "import tensorflow, os; print(os.path.join(os.path.dirname(tensorflow.__file__), 'include'))" 2>/dev/null || python -c "import tensorflow, os; print(os.path.join(os.path.dirname(tensorflow.__file__), 'include'))" 2>/dev/null)
example-pjrt: example/cpp/pjrt-predict
example/cpp/pjrt-predict: example/cpp/pjrt_predict.c
	@test -n "$(PJRT_INC)" || { echo "tensorflow wheel (pjrt_c_api.h) not found"; exit 1; }
	$(CC) -O2 -Wall -I$(PJRT_INC) $< -o $@ -ldl

# flat C ABI (src/c_api.cc) — embeds/attaches the Python interpreter
capi: $(LIBDIR)/libmxtpu_capi.so

$(LIBDIR)/libmxtpu_capi.so: src/c_api.cc include/mxtpu/c_api.h | $(LIBDIR)
	$(CXX) $(CXXFLAGS) -Iinclude $(PY_INCLUDES) -shared $< -o $@ $(PY_LDFLAGS)

$(LIBDIR)/capi_smoke: tests/capi/capi_smoke.c $(LIBDIR)/libmxtpu_capi.so
	$(CC) -O2 -Wall -Iinclude $< -o $@ -L$(LIBDIR) -lmxtpu_capi \
	    -lm -Wl,-rpath,'$$ORIGIN'

$(LIBDIR)/capi_threads: tests/capi/capi_threads.c $(LIBDIR)/libmxtpu_capi.so
	$(CC) -O2 -Wall -Iinclude $< -o $@ -L$(LIBDIR) -lmxtpu_capi \
	    -lpthread -Wl,-rpath,'$$ORIGIN'

$(LIBDIR)/capi_parity: tests/capi/capi_parity.c $(LIBDIR)/libmxtpu_capi.so
	$(CC) -O2 -Wall -Iinclude $< -o $@ -L$(LIBDIR) -lmxtpu_capi \
	    -lm -Wl,-rpath,'$$ORIGIN'

test-capi: $(LIBDIR)/capi_smoke $(LIBDIR)/capi_threads $(LIBDIR)/capi_parity
	python -m pytest tests/test_capi.py -q

# C programs of example/cpp-torch/ against either library: the JAX
# package's here, the port's under $(TORCH_LIBDIR) below
$(LIBDIR)/train_lm: example/cpp-torch/train_lm.c $(LIBDIR)/libmxtpu_capi.so
	$(CC) -O2 -Wall -Iinclude $< -o $@ -L$(LIBDIR) -lmxtpu_capi \
	    -Wl,-rpath,'$$ORIGIN'

$(LIBDIR)/image-classification-predict: \
    example/cpp/image-classification/image-classification-predict.cc \
    $(LIBDIR)/libmxtpu_capi.so
	$(CXX) -O2 -Wall -Iinclude $< -o $@ -L$(LIBDIR) -lmxtpu_capi -lm \
	    -Wl,-rpath,'$$ORIGIN'

# the PyTorch port's flat C ABI: mxnet_tpu_torch/csrc/c_api.cc over the
# same header, and the unchanged C consumers and predictor built against
# it into $(TORCH_LIBDIR) (their rpath finds the library one level up)
TORCH_LIBDIR := $(LIBDIR)/torch
TORCH_CAPI_PROGS := capi_smoke capi_threads capi_parity \
    image-classification-predict train_lm rtc_saxpy

capi-torch: $(LIBDIR)/libmxtpu_torch_capi.so \
    $(TORCH_CAPI_PROGS:%=$(TORCH_LIBDIR)/%)

$(LIBDIR)/libmxtpu_torch_capi.so: mxnet_tpu_torch/csrc/c_api.cc \
    include/mxtpu/c_api.h | $(LIBDIR)
	$(CXX) $(CXXFLAGS) -Iinclude $(PY_INCLUDES) -shared $< -o $@ $(PY_LDFLAGS)

$(TORCH_LIBDIR):
	mkdir -p $(TORCH_LIBDIR)

TORCH_LINK := -L$(LIBDIR) -lmxtpu_torch_capi -lm -lpthread \
    -Wl,-rpath,'$$ORIGIN/..'

$(TORCH_LIBDIR)/%: tests/capi/%.c $(LIBDIR)/libmxtpu_torch_capi.so \
    | $(TORCH_LIBDIR)
	$(CC) -O2 -Wall -Iinclude $< -o $@ $(TORCH_LINK)

$(TORCH_LIBDIR)/%: example/cpp-torch/%.c $(LIBDIR)/libmxtpu_torch_capi.so \
    | $(TORCH_LIBDIR)
	$(CC) -O2 -Wall -Iinclude $< -o $@ $(TORCH_LINK)

$(TORCH_LIBDIR)/image-classification-predict: \
    example/cpp/image-classification/image-classification-predict.cc \
    $(LIBDIR)/libmxtpu_torch_capi.so | $(TORCH_LIBDIR)
	$(CXX) -O2 -Wall -Iinclude $< -o $@ $(TORCH_LINK)

$(LIBDIR):
	mkdir -p $(LIBDIR)

$(LIBDIR)/%.o: src/%.cc | $(LIBDIR)
	$(CXX) $(CXXFLAGS) -c $< -o $@

# only image.o actually includes the shared codec header
$(LIBDIR)/image.o: src/image_codec.h

$(LIBDIR)/libmxtpu.so: $(OBJS)
	$(CXX) $(CXXFLAGS) -shared $(OBJS) -o $@ $(LDLIBS)

clean:
	rm -rf $(LIBDIR)

test: all
	python -m pytest tests/ -q

# multi-process distributed tests (tools/launch.py local tracker); slower,
# so they gate on MXTPU_NIGHTLY (reference: tests/nightly/test_all.sh)
test-nightly: all
	MXTPU_NIGHTLY=1 python -m pytest tests/test_nightly_dist.py -q

.PHONY: all clean test test-nightly test-cpp capi capi-torch test-capi

# native C++ unit test for the engine (reference tests/cpp analog)
$(LIBDIR)/engine_test: tests/cpp/engine_test.cc $(LIBDIR)/engine.o
	$(CXX) $(CXXFLAGS) -Iinclude tests/cpp/engine_test.cc \
	    $(LIBDIR)/engine.o -o $@ -lpthread

$(LIBDIR)/recordio_test: tests/cpp/recordio_test.cc $(LIBDIR)/recordio.o
	$(CXX) $(CXXFLAGS) -Iinclude tests/cpp/recordio_test.cc \
	    $(LIBDIR)/recordio.o -o $@

test-cpp: $(LIBDIR)/engine_test $(LIBDIR)/recordio_test
	$(LIBDIR)/engine_test
	d=$$(mktemp -d) && $(LIBDIR)/recordio_test $$d; rc=$$?; \
	    rm -rf $$d; exit $$rc

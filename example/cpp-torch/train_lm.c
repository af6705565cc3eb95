/* Train a language model through the flat C ABI (include/mxtpu/c_api.h)
 * alone: the same program links the JAX package's library
 * (lib/libmxtpu_capi.so) or the PyTorch port's
 * (lib/libmxtpu_torch_capi.so, on gpu(0) unless MXNET_CAPI_CONTEXT
 * names another context).
 *
 * It reads a symbol JSON, a 0x112 parameter file, the token ids and the
 * labels (raw float32, batch x seq_len each), binds the training graph
 * with MXExecutorSimpleBindTrain, copies the parameters into the bound
 * arguments, then runs --steps times forward(is_train=1), backward and
 * MXOptimizerUpdate on every argument but the data and the label, with
 * SGD (momentum) from MXOptimizerCreateOptimizer.  Each step ends at
 * MXNDArrayWaitAll; the program prints each step's milliseconds and
 * writes the trained parameters with MXNDArraySave.
 *
 * Usage:
 *   train_lm --symbol lm-symbol.json --params lm.params \
 *       --data tokens.f32 --label labels.f32 --batch 8 --seq-len 1024 \
 *       --steps 3 --out trained.params \
 *       [--lr 0.1] [--momentum 0.9] [--wd 0] [--rescale-grad R]
 *       [--data-name data] [--label-name softmax_label]
 * --rescale-grad defaults to 1 / (batch * seq_len).
 */
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>

#include "mxtpu/c_api.h"

#define CHECK(call) do { \
    if ((call) != 0) { \
      fprintf(stderr, "train_lm: %s failed: %s\n", #call, \
              MXGetLastError()); \
      return 1; \
    } } while (0)

static char* read_file(const char* path, size_t* size_out) {
  FILE* f = fopen(path, "rb");
  if (!f) return NULL;
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  char* buf = (char*)malloc((size_t)n + 1);
  if (!buf || fread(buf, 1, (size_t)n, f) != (size_t)n) {
    fclose(f);
    free(buf);
    return NULL;
  }
  fclose(f);
  buf[n] = '\0';
  if (size_out) *size_out = (size_t)n;
  return buf;
}

static double now_ms(void) {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return ts.tv_sec * 1e3 + ts.tv_nsec / 1e6;
}

static size_t numel(NDArrayHandle h) {
  uint32_t ndim = 0, shape[8];
  size_t n = 1;
  if (MXNDArrayGetShape(h, &ndim, shape, 8) != 0) return 0;
  for (uint32_t d = 0; d < ndim; ++d) n *= shape[d];
  return n;
}

int main(int argc, char** argv) {
  const char *symbol = NULL, *params = NULL, *data = NULL, *label = NULL;
  const char *out = NULL, *data_name = "data", *label_name = "softmax_label";
  long batch = 0, seq_len = 0, steps = 1;
  double lr = 0.1, momentum = 0.9, wd = 0.0, rescale = -1.0;
  for (int i = 1; i + 1 < argc; i += 2) {
    const char *k = argv[i], *v = argv[i + 1];
    if (!strcmp(k, "--symbol")) symbol = v;
    else if (!strcmp(k, "--params")) params = v;
    else if (!strcmp(k, "--data")) data = v;
    else if (!strcmp(k, "--label")) label = v;
    else if (!strcmp(k, "--out")) out = v;
    else if (!strcmp(k, "--data-name")) data_name = v;
    else if (!strcmp(k, "--label-name")) label_name = v;
    else if (!strcmp(k, "--batch")) batch = atol(v);
    else if (!strcmp(k, "--seq-len")) seq_len = atol(v);
    else if (!strcmp(k, "--steps")) steps = atol(v);
    else if (!strcmp(k, "--lr")) lr = atof(v);
    else if (!strcmp(k, "--momentum")) momentum = atof(v);
    else if (!strcmp(k, "--wd")) wd = atof(v);
    else if (!strcmp(k, "--rescale-grad")) rescale = atof(v);
    else {
      fprintf(stderr, "train_lm: unknown option %s\n", k);
      return 2;
    }
  }
  if (!symbol || !params || !data || !label || !out || batch <= 0 ||
      seq_len <= 0 || steps <= 0) {
    fprintf(stderr, "usage: %s --symbol S --params P --data D --label L "
            "--batch B --seq-len T --steps N --out O [--lr --momentum --wd "
            "--rescale-grad --data-name --label-name]\n", argv[0]);
    return 2;
  }
  if (rescale < 0) rescale = 1.0 / ((double)batch * (double)seq_len);
  const size_t n_tok = (size_t)batch * (size_t)seq_len;

  char* json = read_file(symbol, NULL);
  if (!json) {
    fprintf(stderr, "train_lm: cannot read %s\n", symbol);
    return 2;
  }
  SymbolHandle sym;
  CHECK(MXSymbolCreateFromJSON(json, &sym));
  free(json);

  char shapes[256];
  snprintf(shapes, sizeof shapes, "{\"%s\": [%ld, %ld], \"%s\": [%ld, %ld]}",
           data_name, batch, seq_len, label_name, batch, seq_len);
  ExecutorHandle exec;
  CHECK(MXExecutorSimpleBindTrain(sym, shapes, &exec));

  /* the token ids and labels */
  const char* inputs[2][2] = {{data_name, data}, {label_name, label}};
  for (int i = 0; i < 2; ++i) {
    size_t got = 0;
    char* raw = read_file(inputs[i][1], &got);
    if (!raw || got != n_tok * sizeof(float)) {
      fprintf(stderr, "train_lm: %s must hold %zu float32\n", inputs[i][1],
              n_tok);
      return 2;
    }
    CHECK(MXExecutorSetArg(exec, inputs[i][0], (const float*)raw, n_tok));
    free(raw);
  }

  /* the parameters: names with or without the checkpoint's "arg:" */
  uint32_t n_loaded = 0, n_names = 0;
  NDArrayHandle* loaded = NULL;
  const char** loaded_names = NULL;
  CHECK(MXNDArrayLoad(params, &n_loaded, &loaded, &n_names, &loaded_names));
  if (n_names != n_loaded) {
    fprintf(stderr, "train_lm: %s has no names\n", params);
    return 2;
  }
  char** names = (char**)malloc(n_loaded * sizeof(char*));
  NDArrayHandle* handles = (NDArrayHandle*)malloc(n_loaded *
                                                  sizeof(NDArrayHandle));
  for (uint32_t i = 0; i < n_loaded; ++i) {
    const char* nm = loaded_names[i];
    names[i] = strdup(strncmp(nm, "arg:", 4) == 0 ? nm + 4 : nm);
    handles[i] = loaded[i];
  }

  uint32_t n_args = 0;
  CHECK(MXExecutorNumArgs(exec, &n_args));
  NDArrayHandle* weights = (NDArrayHandle*)calloc(n_args,
                                                  sizeof(NDArrayHandle));
  NDArrayHandle* grads = (NDArrayHandle*)calloc(n_args,
                                                sizeof(NDArrayHandle));
  const char** arg_names = (const char**)calloc(n_args, sizeof(char*));
  uint32_t n_params = 0;
  for (uint32_t i = 0; i < n_args; ++i) {
    char name[256];
    CHECK(MXExecutorArgName(exec, i, name, sizeof name));
    if (!strcmp(name, data_name) || !strcmp(name, label_name)) continue;
    int found = -1;
    for (uint32_t j = 0; j < n_loaded; ++j)
      if (!strcmp(names[j], name)) found = (int)j;
    if (found < 0) {
      fprintf(stderr, "train_lm: %s lacks parameter %s\n", params, name);
      return 2;
    }
    size_t n = numel(handles[found]);
    float* host = (float*)malloc(n * sizeof(float));
    CHECK(MXNDArraySyncCopyToCPU(handles[found], host, n));
    CHECK(MXExecutorSetArg(exec, name, host, n));
    free(host);
    arg_names[i] = strdup(name);
    CHECK(MXExecutorArgHandle(exec, name, &weights[i]));
    CHECK(MXExecutorGradHandle(exec, name, &grads[i]));
    ++n_params;
  }
  for (uint32_t j = 0; j < n_loaded; ++j) {
    CHECK(MXNDArrayFree(handles[j]));
    free(names[j]);
  }
  free(names);
  free(handles);

  char opt_json[256];
  snprintf(opt_json, sizeof opt_json,
           "{\"learning_rate\": %.9g, \"momentum\": %.9g, \"wd\": %.9g, "
           "\"rescale_grad\": %.17g}", lr, momentum, wd, rescale);
  OptimizerHandle opt;
  CHECK(MXOptimizerCreateOptimizer("sgd", opt_json, &opt));

  double* ms = (double*)malloc((size_t)steps * sizeof(double));
  CHECK(MXNDArrayWaitAll());
  for (long s = 0; s < steps; ++s) {
    double t0 = now_ms();
    uint32_t n_out = 0;
    CHECK(MXExecutorForward(exec, 1, &n_out));
    CHECK(MXExecutorBackward(exec));
    for (uint32_t i = 0; i < n_args; ++i) {
      if (!weights[i]) continue;
      CHECK(MXOptimizerUpdate(opt, (int)i, weights[i], grads[i], -1.0f,
                              -1.0f));
    }
    CHECK(MXNDArrayWaitAll());
    ms[s] = now_ms() - t0;
  }
  for (long s = 0; s < steps; ++s)
    printf("step %ld ms %.3f\n", s, ms[s]);

  /* the trained parameters, in argument order */
  NDArrayHandle* save_h = (NDArrayHandle*)malloc(n_params *
                                                 sizeof(NDArrayHandle));
  const char** save_k = (const char**)malloc(n_params * sizeof(char*));
  uint32_t k = 0;
  for (uint32_t i = 0; i < n_args; ++i) {
    if (!weights[i]) continue;
    save_h[k] = weights[i];
    save_k[k] = arg_names[i];
    ++k;
  }
  CHECK(MXNDArraySave(out, n_params, save_h, save_k));
  printf("params %u saved to %s\n", n_params, out);

  for (uint32_t i = 0; i < n_args; ++i) {
    if (!weights[i]) continue;
    CHECK(MXNDArrayFree(weights[i]));
    CHECK(MXNDArrayFree(grads[i]));
    free((void*)arg_names[i]);
  }
  CHECK(MXOptimizerFree(opt));
  CHECK(MXExecutorFree(exec));
  CHECK(MXSymbolFree(sym));
  CHECK(MXNotifyShutdown());
  free(save_h);
  free(save_k);
  free(weights);
  free(grads);
  free(arg_names);
  free(ms);
  printf("TRAIN_LM OK\n");
  return 0;
}

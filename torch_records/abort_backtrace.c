/* A native backtrace of a process that aborts or faults, for finding which
 * code corrupted the heap when glibc's malloc check aborts a rank.
 *
 * Preloaded into every process of a test run (spawn_steadiness.py
 * --backtrace builds it and sets LD_PRELOAD); on SIGABRT, SIGSEGV or SIGBUS
 * it writes the process id, the signal and the frames to stderr, then lets
 * the signal end the process as it would have.  Python's faulthandler,
 * enabled later, chains to it after printing the Python stack.
 *
 *   gcc -shared -fPIC -O1 -o abort_backtrace.so abort_backtrace.c
 */
#define _GNU_SOURCE
#include <execinfo.h>
#include <signal.h>
#include <stdio.h>
#include <unistd.h>

static void on_fatal(int sig) {
  void *frames[96];
  char head[128];
  int n = snprintf(head, sizeof head, "native backtrace: pid %d, signal %d\n",
                   (int)getpid(), sig);
  if (n > 0) (void)!write(2, head, (size_t)n);
  backtrace_symbols_fd(frames, backtrace(frames, 96), 2);
  signal(sig, SIG_DFL);
  raise(sig);
}

__attribute__((constructor)) static void install(void) {
  void *warm[1];
  /* backtrace() loads libgcc_s with malloc on its first call: make that
   * call now, while the heap is sound. */
  backtrace(warm, 1);
  signal(SIGABRT, on_fatal);
  signal(SIGSEGV, on_fatal);
  signal(SIGBUS, on_fatal);
}

// Interop oracle: drives the *reference* C++ library (built separately from
// /root/reference) to generate serialized test vectors and to decrypt
// ciphertexts produced by gemini_seal.  Used by tests/test_interop.py
// for byte-level wire-format and bit-exact evaluation cross-checks.
//
// Usage:
//   oracle gen <dir>                 write parms/sk/pk/rk/ct1/ct2 + expected
//   oracle dec <dir> <ct_file>       decrypt a ciphertext file, print hex poly
//   oracle ckksgen <dir>             CKKS variant (parms/sk/pk/ct)
//   oracle ckksdec <dir> <ct_file>   decode first 4 slots
#include "seal/seal.h"
#include "seal/util/rlwe.h"
#include <fstream>
#include <iostream>
#include <cmath>
#include <vector>
using namespace seal;
using namespace std;

static EncryptionParameters bfv_parms() {
  EncryptionParameters parms(scheme_type::BFV);
  parms.set_poly_modulus_degree(64);
  parms.set_coeff_modulus(CoeffModulus::Create(64, {40, 40, 40}));
  parms.set_plain_modulus(257);
  return parms;
}

static EncryptionParameters ckks_parms() {
  EncryptionParameters parms(scheme_type::CKKS);
  parms.set_poly_modulus_degree(256);
  parms.set_coeff_modulus(CoeffModulus::Create(256, {40, 30, 30, 40}));
  return parms;
}

template <class T> static void save_to(const T &obj, const string &path) {
  ofstream f(path, ios::binary);
  obj.save(f, compr_mode_type::none);
}

int main(int argc, char **argv) {
  if (argc < 3) { cerr << "usage: oracle gen|dec|ckksgen|ckksdec <dir> [file]\n"; return 2; }
  string cmd = argv[1], dir = argv[2];

  if (cmd == "gen") {
    auto parms = bfv_parms();
    auto ctx = SEALContext::Create(parms, true, sec_level_type::none);
    KeyGenerator keygen(ctx);
    auto pk = keygen.public_key();
    auto sk = keygen.secret_key();
    Encryptor enc(ctx, pk);
    save_to(parms, dir + "/parms.bin");
    save_to(sk, dir + "/sk.bin");
    save_to(pk, dir + "/pk.bin");
    Plaintext p1("3x^2 + 2"), p2("2x^1 + 1");
    Ciphertext c1, c2;
    enc.encrypt(p1, c1); enc.encrypt(p2, c2);
    save_to(c1, dir + "/ct1.bin");
    save_to(c2, dir + "/ct2.bin");
    cout << "gen ok" << endl;
    return 0;
  }
  if (cmd == "dec") {
    auto parms = bfv_parms();
    auto ctx = SEALContext::Create(parms, true, sec_level_type::none);
    SecretKey sk;
    { ifstream f(dir + "/sk.bin", ios::binary); sk.load(ctx, f); }
    Decryptor dec(ctx, sk);
    Ciphertext c;
    { ifstream f(argv[3], ios::binary); c.load(ctx, f); }
    Plaintext out;
    dec.decrypt(c, out);
    cout << out.to_string() << endl;
    return 0;
  }
  if (cmd == "ckksgen") {
    auto parms = ckks_parms();
    auto ctx = SEALContext::Create(parms, true, sec_level_type::none);
    KeyGenerator keygen(ctx);
    auto pk = keygen.public_key();
    auto sk = keygen.secret_key();
    Encryptor enc(ctx, pk);
    CKKSEncoder encoder(ctx);
    save_to(parms, dir + "/ckks_parms.bin");
    save_to(sk, dir + "/ckks_sk.bin");
    save_to(pk, dir + "/ckks_pk.bin");
    vector<double> v{1.5, -2.25, 3.0, 0.125};
    Plaintext p; encoder.encode(v, pow(2.0, 30), p);
    Ciphertext c; enc.encrypt(p, c);
    save_to(c, dir + "/ckks_ct.bin");
    cout << "ckksgen ok" << endl;
    return 0;
  }
  if (cmd == "ckksdec") {
    auto parms = ckks_parms();
    auto ctx = SEALContext::Create(parms, true, sec_level_type::none);
    SecretKey sk;
    { ifstream f(dir + "/ckks_sk.bin", ios::binary); sk.load(ctx, f); }
    Decryptor dec(ctx, sk);
    CKKSEncoder encoder(ctx);
    Ciphertext c;
    { ifstream f(argv[3], ios::binary); c.load(ctx, f); }
    Plaintext out;
    dec.decrypt(c, out);
    vector<double> res; encoder.decode(out, res);
    printf("%.6f %.6f %.6f %.6f\n", res[0], res[1], res[2], res[3]);
    return 0;
  }
  if (cmd == "genkeys") {
    // Emit relin + galois keys alongside the standard gen artifacts, for
    // cross-implementation key-switching interop tests.
    auto parms = bfv_parms();
    auto ctx = SEALContext::Create(parms, true, sec_level_type::none);
    KeyGenerator keygen(ctx);
    auto pk = keygen.public_key();
    auto sk = keygen.secret_key();
    auto rk = keygen.relin_keys_local();
    auto gk = keygen.galois_keys_local(vector<int>{1});
    // generator-3 element for BatchEncoder-compatible row rotation
    auto gk3 = keygen.galois_keys_local(vector<uint32_t>{3});
    save_to(gk3, dir + "/gk3.bin");
    Encryptor enc(ctx, pk);
    save_to(parms, dir + "/parms.bin");
    save_to(sk, dir + "/sk.bin");
    save_to(pk, dir + "/pk.bin");
    save_to(rk, dir + "/rk.bin");
    save_to(gk, dir + "/gk.bin");
    BatchEncoder be(ctx);
    vector<uint64_t> v(be.slot_count());
    for (size_t i = 0; i < v.size(); i++) v[i] = i % 17;
    Plaintext p; be.encode(v, p);
    Ciphertext c; enc.encrypt(p, c);
    save_to(c, dir + "/ct_batch.bin");
    cout << "genkeys ok" << endl;
    return 0;
  }
  if (cmd == "decbatch") {
    auto parms = bfv_parms();
    auto ctx = SEALContext::Create(parms, true, sec_level_type::none);
    SecretKey sk;
    { ifstream f(dir + "/sk.bin", ios::binary); sk.load(ctx, f); }
    Decryptor dec(ctx, sk);
    BatchEncoder be(ctx);
    Ciphertext c;
    { ifstream f(argv[3], ios::binary); c.load(ctx, f); }
    Plaintext out;
    dec.decrypt(c, out);
    vector<uint64_t> v; be.decode(out, v);
    for (int i = 0; i < 8; i++) printf("%llu ", (unsigned long long)v[i]);
    printf("\n");
    return 0;
  }
  if (cmd == "expandrelin") {
    // Load (seed-expanding) a RelinKeys blob produced elsewhere and re-save
    // it expanded — verifies the reference regenerates the same key c1
    // polynomials from the published seeds.
    auto parms = bfv_parms();
    auto ctx = SEALContext::Create(parms, true, sec_level_type::none);
    RelinKeys rk;
    { ifstream f(argv[3], ios::binary); rk.load(ctx, f); }
    save_to(rk, dir + "/rk_expanded.bin");
    cout << "expandrelin ok" << endl;
    return 0;
  }
  if (cmd == "budget") {
    // Print the reference's invariant noise budget for a ciphertext file —
    // the absolute-noise cross-check for the noise-accounting harness.
    auto parms = bfv_parms();
    auto ctx = SEALContext::Create(parms, true, sec_level_type::none);
    SecretKey sk;
    { ifstream f(dir + "/sk.bin", ios::binary); sk.load(ctx, f); }
    Decryptor dec(ctx, sk);
    Ciphertext c;
    { ifstream f(argv[3], ios::binary); c.load(ctx, f); }
    cout << dec.invariant_noise_budget(c) << endl;
    return 0;
  }
  if (cmd == "seededsk") {
    // Generate the secret key under a pinned BlakePRNG seed and dump its
    // NTT-form limbs as hex, for bit-exact PRNG/sampler/NTT parity checks.
    auto parms = bfv_parms();
    random_seed_type seed;
    for (size_t i = 0; i < seed.size(); i++) seed[i] = 91 + i;  // {91..98}
    parms.set_random_generator(make_shared<BlakePRNGFactory>(seed));
    auto ctx = SEALContext::Create(parms, true, sec_level_type::none);
    KeyGenerator keygen(ctx);
    auto sk = keygen.secret_key();
    const uint64_t *d = sk.data().data();
    size_t count = sk.data().coeff_count();
    for (size_t i = 0; i < count; i++) printf("%llx\n", (unsigned long long)d[i]);
    return 0;
  }
  if (cmd == "seedednoise") {
    // Dump util::sample_poly_normal under a pinned seed (libstdc++
    // normal_distribution parity check).
    auto parms = bfv_parms();
    random_seed_type seed;
    for (size_t i = 0; i < seed.size(); i++) seed[i] = 91 + i;
    auto rng = make_shared<BlakePRNG>(seed);
    size_t n = parms.poly_modulus_degree();
    size_t L = parms.coeff_modulus().size();
    vector<uint64_t> dest(n * L);
    util::sample_poly_normal(rng, parms, dest.data());
    for (size_t i = 0; i < dest.size(); i++) printf("%llx\n", (unsigned long long)dest[i]);
    return 0;
  }
  cerr << "unknown command\n";
  return 2;
}

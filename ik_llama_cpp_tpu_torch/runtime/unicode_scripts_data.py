"""Unicode script-property table (UCD Scripts.txt, UAX #24).

Generated by tools/gen_unicode_scripts.py — pure spec data.
``SEGMENT_LASTS[i]`` is the last codepoint of segment i, whose
script name is ``SCRIPT_NAMES[SEGMENT_SCRIPT[i]]``; lookup is
bisect_left on SEGMENT_LASTS. Do not edit by hand."""

SCRIPT_NAMES = (
    "adlam", "ahom", "anatolian_hieroglyphs", "arabic", "armenian", "avestan",
    "balinese", "bamum", "bassa_vah", "batak", "bengali", "beria_erfe",
    "bhaiksuki", "bopomofo", "brahmi", "braille", "buginese", "buhid",
    "canadian_aboriginal", "carian", "caucasian_albanian", "chakma", "cham", "cherokee",
    "chorasmian", "common", "coptic", "cuneiform", "cypriot", "cypro_minoan",
    "cyrillic", "deseret", "devanagari", "dives_akuru", "dogra", "duployan",
    "egyptian_hieroglyphs", "elbasan", "elymaic", "ethiopic", "garay", "georgian",
    "glagolitic", "gothic", "grantha", "greek", "gujarati", "gunjala_gondi",
    "gurmukhi", "gurung_khema", "han", "hangul", "hanifi_rohingya", "hanunoo",
    "hatran", "hebrew", "hiragana", "imperial_aramaic", "inherited", "inscriptional_pahlavi",
    "inscriptional_parthian", "javanese", "kaithi", "kannada", "katakana", "kawi",
    "kayah_li", "kharoshthi", "khitan_small_script", "khmer", "khojki", "khudawadi",
    "kirat_rai", "lao", "latin", "lepcha", "limbu", "linear_a",
    "linear_b", "lisu", "lycian", "lydian", "mahajani", "makasar",
    "malayalam", "mandaic", "manichaean", "marchen", "masaram_gondi", "medefaidrin",
    "meetei_mayek", "mende_kikakui", "meroitic_cursive", "meroitic_hieroglyphs", "miao", "modi",
    "mongolian", "mro", "multani", "myanmar", "nabataean", "nag_mundari",
    "nandinagari", "new_tai_lue", "newa", "nko", "nushu", "nyiakeng_puachue_hmong",
    "ogham", "ol_chiki", "ol_onal", "old_hungarian", "old_italic", "old_north_arabian",
    "old_permic", "old_persian", "old_sogdian", "old_south_arabian", "old_turkic", "old_uyghur",
    "oriya", "osage", "osmanya", "pahawh_hmong", "palmyrene", "pau_cin_hau",
    "phags_pa", "phoenician", "psalter_pahlavi", "rejang", "runic", "samaritan",
    "saurashtra", "sharada", "shavian", "siddham", "sidetic", "signwriting",
    "sinhala", "sogdian", "sora_sompeng", "soyombo", "sundanese", "sunuwar",
    "syloti_nagri", "syriac", "tagalog", "tagbanwa", "tai_le", "tai_tham",
    "tai_viet", "tai_yo", "takri", "tamil", "tangsa", "tangut",
    "telugu", "thaana", "thai", "tibetan", "tifinagh", "tirhuta",
    "todhri", "tolong_siki", "toto", "tulu_tigalari", "ugaritic", "vai",
    "vithkuqi", "wancho", "warang_citi", "yezidi", "yi", "zanabazar_square",
)

_LASTS_HEX = (
    "40,5a,60,7a,a9,aa,b9,ba,bf,d6,d7,f6,"
    "f7,2b8,2df,2e4,2e9,2eb,2ff,36f,373,374,377,37d,"
    "37e,37f,384,385,386,387,38a,38c,3a1,3e1,3ef,3ff,"
    "484,486,52f,556,58a,58f,5c7,5ea,5f4,604,605,60b,"
    "60c,61a,61b,61e,61f,63f,640,64a,655,66f,670,6dc,"
    "6dd,6ff,70d,74a,74f,77f,7b1,7fa,7ff,82d,83e,85b,"
    "85e,86a,891,8e1,8e2,8ff,950,954,963,965,97f,983,"
    "98c,990,9a8,9b0,9b2,9b9,9c4,9c8,9ce,9d7,9dd,9e3,"
    "9fe,a03,a0a,a10,a28,a30,a33,a36,a39,a3c,a42,a48,"
    "a4d,a51,a5c,a5e,a76,a83,a8d,a91,aa8,ab0,ab3,ab9,"
    "ac5,ac9,acd,ad0,ae3,af1,aff,b03,b0c,b10,b28,b30,"
    "b33,b39,b44,b48,b4d,b57,b5d,b63,b77,b83,b8a,b90,"
    "b95,b9a,b9c,b9f,ba4,baa,bb9,bc2,bc8,bcd,bd0,bd7,"
    "bfa,c0c,c10,c28,c39,c44,c48,c4d,c56,c5a,c5d,c63,"
    "c6f,c7f,c8c,c90,ca8,cb3,cb9,cc4,cc8,ccd,cd6,cde,"
    "ce3,cef,cf3,d0c,d10,d44,d48,d4f,d63,d7f,d83,d96,"
    "db1,dbb,dbd,dc6,dca,dd4,dd6,ddf,def,df4,e3a,e3f,"
    "e5b,e82,e84,e8a,ea3,ea5,ebd,ec4,ec6,ece,ed9,edf,"
    "f47,f6c,f97,fbc,fcc,fd4,fd8,fda,109f,10c5,10c7,10cd,"
    "10fa,10fb,10ff,11ff,1248,124d,1256,1258,125d,1288,128d,12b0,"
    "12b5,12be,12c0,12c5,12d6,1310,1315,135a,137c,1399,13f5,13fd,"
    "167f,169c,16ea,16ed,16f8,1715,171f,1734,1736,1753,176c,1770,"
    "1773,17dd,17e9,17f9,1801,1803,1804,1805,1819,1878,18aa,18f5,"
    "191e,192b,193b,1940,194f,196d,1974,19ab,19c9,19da,19df,19ff,"
    "1a1b,1a1f,1a5e,1a7c,1a89,1a99,1aad,1add,1aeb,1b4c,1b7f,1bbf,"
    "1bf3,1bff,1c37,1c49,1c4f,1c7f,1c8a,1cba,1cbf,1cc7,1cd2,1cd3,"
    "1ce0,1ce1,1ce8,1cec,1ced,1cf3,1cf4,1cf7,1cf9,1cfa,1d25,1d2a,"
    "1d2b,1d5c,1d61,1d65,1d6a,1d77,1d78,1dbe,1dbf,1dff,1eff,1f15,"
    "1f1d,1f45,1f4d,1f57,1f59,1f5b,1f5d,1f7d,1fb4,1fc4,1fd3,1fdb,"
    "1fef,1ff4,1ffe,200b,200d,2064,2070,2071,207e,207f,208e,209c,"
    "20c1,20f0,2125,2126,2129,212b,2131,2132,214d,214e,215f,2188,"
    "218b,2429,244a,27ff,28ff,2b73,2bff,2c5f,2c7f,2cf3,2cff,2d25,"
    "2d27,2d2d,2d67,2d70,2d7f,2d96,2da6,2dae,2db6,2dbe,2dc6,2dce,"
    "2dd6,2dde,2dff,2e5d,2e99,2ef3,2fd5,3004,3005,3006,3007,3020,"
    "3029,302d,302f,3037,303b,303f,3096,309a,309c,309f,30a0,30fa,"
    "30fc,30ff,312f,318e,319f,31bf,31e5,31ef,31ff,321e,325f,327e,"
    "32cf,32fe,32ff,3357,33ff,4dbf,4dff,9fff,a48c,a4c6,a4ff,a62b,"
    "a69f,a6f7,a721,a787,a78a,a7dc,a7ff,a82c,a839,a877,a8c5,a8d9,"
    "a8ff,a92d,a92e,a92f,a953,a95f,a97c,a9cd,a9cf,a9d9,a9df,a9fe,"
    "aa36,aa4d,aa59,aa5f,aa7f,aac2,aadf,aaf6,ab06,ab0e,ab16,ab26,"
    "ab2e,ab5a,ab5b,ab64,ab65,ab69,ab6b,abbf,abed,abf9,d7a3,d7c6,"
    "d7fb,fa6d,fad9,fb06,fb17,fb36,fb3c,fb3e,fb41,fb44,fb4f,fd3d,"
    "fd3f,fdcf,fdff,fe0f,fe19,fe2d,fe2f,fe52,fe66,fe6b,fe74,fefc,"
    "feff,ff20,ff3a,ff40,ff5a,ff65,ff6f,ff70,ff9d,ff9f,ffbe,ffc7,"
    "ffcf,ffd7,ffdc,ffe6,ffee,fffd,1000b,10026,1003a,1003d,1004d,1005d,"
    "100fa,10102,10133,1013f,1018e,1019c,101a0,101fc,101fd,1029c,102d0,102e0,"
    "102fb,10323,1032f,1034a,1037a,1039d,1039f,103c3,103d5,1044f,1047f,1049d,"
    "104a9,104d3,104fb,10527,10563,1056f,1057a,1058a,10592,10595,105a1,105b1,"
    "105b9,105bc,105f3,10736,10755,10767,10785,107b0,107ba,10805,10808,10835,"
    "10838,1083c,1083f,10855,1085f,1087f,1089e,108af,108f2,108f5,108ff,1091b,"
    "1091f,10939,1093f,10959,1099f,109b7,109cf,109ff,10a03,10a06,10a13,10a17,"
    "10a35,10a3a,10a48,10a58,10a7f,10a9f,10ae6,10af6,10b35,10b3f,10b55,10b5f,"
    "10b72,10b7f,10b91,10b9c,10baf,10c48,10cb2,10cf2,10cff,10d27,10d39,10d65,"
    "10d85,10d8f,10e7e,10ea9,10ead,10eb1,10ec7,10ed8,10eff,10f27,10f59,10f89,"
    "10fcb,10ff6,1104d,11075,1107f,110c2,110cd,110e8,110f9,11134,11147,11176,"
    "111df,111f4,11211,11241,11286,11288,1128d,1129d,112a9,112ea,112f9,11303,"
    "1130c,11310,11328,11330,11333,11339,1133b,11344,11348,1134d,11350,11357,"
    "11363,1136c,11374,11389,1138b,1138e,113b5,113c0,113c2,113c5,113ca,113d5,"
    "113d8,113e2,1145b,11461,114c7,114d9,115b5,115dd,11644,11659,1166c,116b9,"
    "116c9,116e3,1171a,1172b,11746,1183b,118f2,118ff,11906,11909,11913,11916,"
    "11935,11938,11946,11959,119a7,119d7,119e4,11a47,11aa2,11abf,11af8,11b09,"
    "11b67,11be1,11bf9,11c08,11c36,11c45,11c6c,11c8f,11ca7,11cb6,11d06,11d09,"
    "11d36,11d3a,11d3d,11d47,11d59,11d65,11d68,11d8e,11d91,11d98,11da9,11ddb,"
    "11de9,11ef8,11f10,11f3a,11f5a,11fb0,11ff1,11fff,12399,1246e,12474,12543,"
    "12ff2,13455,143fa,14646,16139,16a38,16a5e,16a69,16a6f,16abe,16ac9,16aed,"
    "16af5,16b45,16b59,16b61,16b77,16b8f,16d79,16e9a,16eb8,16ed3,16f4a,16f87,"
    "16f9f,16fe0,16fe1,16fe3,16fe4,16ff6,18aff,18cd5,18cff,18d1e,18df2,1aff3,"
    "1affb,1affe,1b000,1b11f,1b122,1b132,1b152,1b155,1b167,1b2fb,1bc6a,1bc7c,"
    "1bc88,1bc99,1bc9f,1bca3,1ccfc,1ceb3,1ced0,1cef0,1cf2d,1cf46,1cfc3,1d0f5,"
    "1d126,1d166,1d169,1d17a,1d182,1d184,1d18b,1d1a9,1d1ad,1d1ea,1d245,1d2d3,"
    "1d2f3,1d356,1d378,1d454,1d49c,1d49f,1d4a2,1d4a6,1d4ac,1d4b9,1d4bb,1d4c3,"
    "1d505,1d50a,1d514,1d51c,1d539,1d53e,1d544,1d546,1d550,1d6a5,1d7cb,1d7ff,"
    "1da8b,1da9f,1daaf,1df1e,1df2a,1e006,1e018,1e021,1e024,1e02a,1e06d,1e08f,"
    "1e12c,1e13d,1e149,1e14f,1e2ae,1e2f9,1e2ff,1e4f9,1e5fa,1e5ff,1e6de,1e6f5,"
    "1e6ff,1e7e6,1e7eb,1e7ee,1e7fe,1e8c4,1e8d6,1e94b,1e959,1e95f,1ecb4,1ed3d,"
    "1ee03,1ee1f,1ee22,1ee24,1ee27,1ee32,1ee37,1ee39,1ee3b,1ee42,1ee47,1ee49,"
    "1ee4b,1ee4f,1ee52,1ee54,1ee57,1ee59,1ee5b,1ee5d,1ee5f,1ee62,1ee64,1ee6a,"
    "1ee72,1ee77,1ee7c,1ee7e,1ee89,1ee9b,1eea3,1eea9,1eebb,1eef1,1f02b,1f093,"
    "1f0ae,1f0bf,1f0cf,1f0f5,1f1ad,1f1ff,1f200,1f202,1f23b,1f248,1f251,1f265,"
    "1f6d8,1f6ec,1f6fc,1f7d9,1f7eb,1f7f0,1f80b,1f847,1f859,1f887,1f8ad,1f8bb,"
    "1f8c1,1f8d8,1fa57,1fa6d,1fa7c,1fa8a,1fac6,1fac8,1fadc,1faea,1faf8,1fb92,"
    "1fbfa,2a6df,2b81d,2cead,2ebe0,2ee5d,2fa1d,3134a,33479,e0001,e007f,e01ef,"
)

_SCRIPT_IDX_HEX = (
    "194a194a194a194a194a194a194a194a190d193a2d192d2d192d2d192d192d2d"
    "2d2d1a2d1e3a1e04040437373703190319031903190319033a033a0319039191"
    "91039d6969838355559103031903203a2019200a0a0a0a0a0a0a0a0a0a0a0a0a"
    "0a303030303030303030303030303030302e2e2e2e2e2e2e2e2e2e2e2e2e2e78"
    "78787878787878787878787878999999999999999999999999999999999c9c9c"
    "9c9c9c9c9c9c9c9c9c9c3f3f3f3f3f3f3f3f3f3f3f3f3f545454545454548a8a"
    "8a8a8a8a8a8a8a8a8a8a9e199e49494949494949494949499f9f9f9f9f9f199f"
    "63292929291929332727272727272727272727272727272727271717126c8219"
    "82929235191193939345454560196019606060124c4c4c4c4c94946767676745"
    "101095959595953a3a06068e09094b4b4b6d1e29298e3a193a193a193a193a19"
    "3a194a2d1e4a2d4a2d4a1e4a2d3a4a2d2d2d2d2d2d2d2d2d2d2d2d2d2d2d2d19"
    "3a19194a194a194a193a192d194a194a194a194a191919190f19192a4a1a1a29"
    "2929a0a0a02727272727272727271e193232321932193219323a33193219383a"
    "1938194019400d33190d1919403319331940194019321932acac4fa71e07194a"
    "194a4a90197e8484204219428181333d193d3d63161616166396965a27272727"
    "274a194a2d4a19175a5a33333332324a04373737373737031903033a193a1e19"
    "1919030319194a194a194019401933333333331919194e4e4e4e4e4e4e191919"
    "2d192d193a50133a1970702b72a6a673731f867a7a7979251414a8a8a8a8a8a8"
    "a8a8a24d4d4d4a4a4a1c1c1c1c1c1c39397c64643636367f7f5151885d5c5c5c"
    "43434343434343437571565605053c3c3b3b808080766f6f6f343428282803ab"
    "abab030303748b7718260e0e0e3e3e8c8c151552858a4646626262626247472c"
    "2c2c2c2c2c2c3a2c2c2c2c2c2c2c2ca5a5a5a5a5a5a5a5a5a5a56868a1a18787"
    "5f5f6098986301010122aaaa2121212121212121666666ad8d127d20858f8f0c"
    "0c0c0c575757585858585858582f2f2f2f2f2fa3a3534141414f99991b1b1b1b"
    "1d24240231076161619a9a08087b7b7b7b7b48590b0b5e5e5e9b6a3244329b44"
    "449b9b404040403840383840406a232323232319191919193a3a191919193a19"
    "3a193a193a192d19191919191919191919191919191919191919191919191919"
    "8989894a4a2a2a2a2a2a1e1e6b6b6b6ba4a9a9656e6e979797272727275b5b00"
    "0000191903030303030303030303030303030303030303030303030303030303"
    "0303030303031919191919191919381919191919191919191919191919191919"
    "19191919191919191919191919323232323232323219193a"
)

SEGMENT_LASTS = tuple(int(v, 16) for v in
                      "".join(_LASTS_HEX).rstrip(",").split(","))
_j = "".join(_SCRIPT_IDX_HEX)
SEGMENT_SCRIPT = tuple(int(_j[i:i + 2], 16)
                       for i in range(0, len(_j), 2))
assert len(SEGMENT_LASTS) == len(SEGMENT_SCRIPT)
